// Encoder self-attention read straight out of a packed QKV projection, for
// Hopper (sm_90a): qkv [B * Sp, 3 * H * dh] (f32 or bf16; q, k, v of head h
// at columns h dh, (H + h) dh, (2H + h) dh), keys at or past kv_len masked,
// out [B * Sp, H * dh] in qkv's type or, with a fused static requantize,
// int8 (clip(round(o * out_inv), 127)).
//
// Replaces three TPU kernels of gvl_tpu/ops/quant_matmul.py, one body:
// - attention_fused_qkv_pallas (Pallas body _padded_attn_kernel): heads
//   padded to dh 128 (the pad columns are data here: all 128 are computed),
//   softmax in exp2 form (the scale carries log2 e), optional requantize
//   (its int8_scores option is csrc/encoder_attention_int8.cu);
// - attention_packed_multihead_pallas (_packed_mh_attn_kernel): the same
//   math on unpadded heads (dh 72 in so400m);
// - attention_qkv_packed_pallas (_packed_attn_kernel): unpadded heads,
//   softmax with exp, output in qkv's type.
//
// Semantics that fix the design.  p is formed against each row's exact
// maximum and rounded to v's type before P V, and the denominator sums the
// unrounded p, as the TPU body does.  An
// online softmax would round p against running maxima and flip int8
// requantized outputs, so there are two passes over the keys: the first
// computes q k^T for the row maxima only, the second recomputes it (the
// same instructions, so the same values) and accumulates P V.
//
// Design.  Tensor cores through mma.sync (csrc/mma.cuh).  The TPU kernel
// holds all Sp keys of a head in VMEM (377 KB at Sp 736, dh 128); here one
// block of 4 warps takes a (128-row query tile, head, image), each warp two
// 16-row m-tiles, so that every K or V fragment read from shared memory
// feeds two products (FlashAttention-2's layout).  64-key K and V tiles
// pass through a two-stage ring in shared memory, loaded with 16-byte
// cp.async copies straight from their column offsets in the packed buffer
// (no transpose or pad is materialised) and prefetched across the boundary
// between the passes.  Shared rows are kD + 8 bf16 wide (an odd number of
// 16-byte units), so ldmatrix reads hit distinct banks; kD is 80 for heads
// up to 80 wide (so400m's 72) and 128 above.  Columns dh .. kD - 1 and key
// rows at or past kv_len are zero-filled on load, so every product runs
// over the whole kD unconditionally (a runtime test around mma.sync costs a
// warp convergence barrier each time) and no value past kv_len reaches
// P V; the scores of those keys are masked on the last tile only.
// - bf16 qkv: m16n8k16 bf16 products with f32 sums.  The score fragments,
//   rounded pairwise to bf16, are the A fragments of P V (FlashAttention-2's
//   register reuse); the Q fragments are read from shared memory at each
//   k-step (the output accumulators take 128 registers at dh 128).
// - f32 qkv (on no served path): every operand is split into bf16 hi + lo
//   and each product is hi.hi + hi.lo + lo.hi (f32-level error; lo.lo is
//   ~2^-16 relative), so one body serves both types; one m-tile per warp.
// Pass 1 keeps the largest unscaled dot (times the scale's sign) and
// scales it once; pass 2 scales every score, subtracts that maximum and
// takes exp2 as one MUFU.EX2 (exp2f's fast path) or expf, the choice made
// once per tile rather than around every key.  The epilogue divides by the
// denominator with __fdiv_rn and requantizes with __fmul_rn and
// half-to-even rounding, as the plain version does.
//
// Bound.  At the so400m layer of a batch of 8 frames (B 8, H 16, Sp 736,
// kv_len 729) the minimal work is 4 dh flops per live (query, key) pair:
// 35 GFLOP at dh 128, 0.036 ms at the 989 TFLOP/s bf16 dense peak
// (19.8 GFLOP at dh 72), against 36 MB of traffic: operation-bound.  The
// second q k^T pass adds half again (58 GFLOP issued at dh 128, with the
// padding of Sp to 768 rows), and mma.sync, issued from the warps'
// registers, reaches a fraction of the peak.  A wgmma design would keep the
// ring fed by TMA from one producer warp, run a 64-row warpgroup's products
// asynchronously with B read from shared memory (no ldmatrix), and overlap
// the softmax of one tile with the products of the next.
#include "mma.cuh"

namespace gvl {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows of one 16-row m-tile per warp
constexpr int kBK = 64;             // keys per shared-memory tile
constexpr int D = 128;              // widest head
static_assert(kRows == kBK, "a Q tile and a K/V tile share one size");

// bf16 per shared row of a head kD wide (88 or 136: an odd number of
// 16-byte units), and per tile
template <int kD>
constexpr int kLdOf = kD + 8;
template <int kD>
constexpr int kTileElems = kBK * kLdOf<kD>;

// key rows (or query rows) row0 .. row0 + 63 of one head's column block
// col0 .. col0 + dh - 1 into dst [64][kD + 8] bf16 (with f32 input the hi
// and lo halves into dst and dst_lo); zero at rows >= row_end and in
// columns dh .. kD - 1
template <typename T, int kD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, __nv_bfloat16* dst_lo,
                                          const T* __restrict__ base, int width,
                                          int col0, int row0, int row_end, int dh) {
  constexpr int kChunks = kD / 8, kLd = kLdOf<kD>;  // 16-byte bf16 units per row
#pragma unroll 4
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool valid = row0 + r < row_end && c < dh;
    const T* src = base + (size_t)(valid ? row0 + r : 0) * width + col0 + (valid ? c : 0);
    if constexpr (sizeof(T) == 2) {
      cp_async16(dst + r * kLd + c, src, valid);
    } else {
      float x[8];
      if (valid) {
        load_f32<T, 8>(src, x);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
      __align__(16) __nv_bfloat16 hi[8], lo[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) split_bf16(x[e], hi[e], lo[e]);
      *reinterpret_cast<uint4*>(dst + r * kLd + c) = *reinterpret_cast<const uint4*>(hi);
      *reinterpret_cast<uint4*>(dst_lo + r * kLd + c) = *reinterpret_cast<const uint4*>(lo);
    }
  }
}

// bf16 (one product) or f32 (hi/lo split, three products) qkv, heads up to
// kD wide.  Each warp owns kM m-tiles of 16 query rows (a block 64 kM
// rows), so every K and V fragment read from shared memory feeds kM
// products; the Q fragments are read from shared memory at each k-step.
template <typename T, bool kQuantOut, int kD, int kM>
__global__ void __launch_bounds__(kThreads)
encoder_attention_mma_kernel(const T* __restrict__ qkv, void* __restrict__ out,
                             int heads, int seq_pad, int kv_len, int dh, float scale,
                             int use_exp2, float out_inv) {
  constexpr int kParts = sizeof(T) == 4 ? 2 : 1;  // bf16 hi (and lo) tiles
  constexpr int kLd = kLdOf<kD>;
  constexpr int kT = kTileElems<kD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // K of stage s part p (hi, lo) at tile kParts s + p, V at kParts (2 + s)
  // + p, then Q: kM tiles of 64 rows per part
  __nv_bfloat16* const smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* const qs = smem + 4 * kParts * kT;

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, mi = lane / 8, mr = lane % 8;
  const int q0 = blockIdx.x * kRows * kM;
  const int width = 3 * heads * dh;
  const T* base = qkv + (size_t)b * seq_pad * width;
  const int qcol = h * dh, kcol = (heads + h) * dh, vcol = (2 * heads + h) * dh;
  const int n_vt = dh / 8;  // n8 output column tiles
  const int n_tiles = (kv_len + kBK - 1) / kBK;
  const float sgn = scale < 0.f ? -1.f : 1.f;

  // pass 1 visits the K tiles, pass 2 the K and V tiles again; tile it + 1
  // is in flight while tile it is consumed, across the passes too
  auto load = [&](int it, int stage) {
    const int k0 = (it < n_tiles ? it : it - n_tiles) * kBK;
    __nv_bfloat16* ks = smem + kParts * stage * kT;
    load_tile<T, kD>(ks, ks + kT, base, width, kcol, k0, kv_len, dh);
    if (it >= n_tiles) {
      __nv_bfloat16* vs = smem + kParts * (2 + stage) * kT;
      load_tile<T, kD>(vs, vs + kT, base, width, vcol, k0, kv_len, dh);
    }
  };
#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
    load_tile<T, kD>(qs + mt * kT, qs + (kM + mt) * kT, base, width, qcol, q0 + mt * kBK,
                     seq_pad, dh);
  load(0, 0);
  cp_async_commit();

  float o[kM][kD / 8][4];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) m[mt][r] = kNegInf, l[mt][r] = 0.f;
  // this lane's ldmatrix row in the Q tiles: warp rows 16 kM warp + 16 mt
  const int qrow = (warp * kM * 16 + (mi & 1) * 8 + mr) * kLd + (mi >> 1) * 8;

  // s = q k^T (unscaled) for this warp's 16 kM rows and the 64 keys of the
  // K tile at ks
  float s[kM][kBK / 8][4];
  auto qk = [&](const __nv_bfloat16* ks) {
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      unsigned qa[kParts][kM][4];
#pragma unroll
      for (int p = 0; p < kParts; ++p)
#pragma unroll
        for (int mt = 0; mt < kM; ++mt)
          ldmatrix_x4(qa[p][mt], qs + p * kM * kT + qrow + mt * 16 * kLd + kk * 16);
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        const int off = (np * 16 + (mi >> 1) * 8 + mr) * kLd + kk * 16 + (mi & 1) * 8;
        unsigned kb[4];
        ldmatrix_x4(kb, ks + off);
        if constexpr (kParts == 2) {
          unsigned kl[4];
          ldmatrix_x4(kl, ks + kT + off);  // the lo tile follows
#pragma unroll
          for (int mt = 0; mt < kM; ++mt) {
            mma_bf16(s[mt][2 * np], qa[1][mt], kb[0], kb[1]);
            mma_bf16(s[mt][2 * np + 1], qa[1][mt], kb[2], kb[3]);
            mma_bf16(s[mt][2 * np], qa[0][mt], kl[0], kl[1]);
            mma_bf16(s[mt][2 * np + 1], qa[0][mt], kl[2], kl[3]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
          mma_bf16(s[mt][2 * np], qa[0][mt], kb[0], kb[1]);
          mma_bf16(s[mt][2 * np + 1], qa[0][mt], kb[2], kb[3]);
        }
      }
    }
  };
  // the keys at or past kv_len, all in the last tile, take `value`
  auto mask = [&](int k0, float value) {
    if (k0 + kBK <= kv_len) return;
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + 2 * t + (e & 1) >= kv_len) s[mt][n][e] = value;
  };
  // the largest dot times the sign of the scale: rounding is monotonic, so
  // that dot times the scale is exactly the largest score
  auto row_max = [&](auto signed_dot) {
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          m[mt][e >> 1] = fmaxf(m[mt][e >> 1], signed_dot(s[mt][n][e]));
  };

  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int stage = it & 1;
    const bool second = it >= n_tiles;
    const int k0 = (second ? it - n_tiles : it) * kBK;
    if (it + 1 < 2 * n_tiles) {
      load(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = smem + kParts * stage * kT;
    const __nv_bfloat16* vs = smem + kParts * (2 + stage) * kT;

    qk(ks);
    if (!second) {
      mask(k0, sgn * kNegInf);
      if (sgn > 0.f)
        row_max([](float x) { return x; });
      else
        row_max([](float x) { return -x; });
    } else {
      if (it == n_tiles) {
#pragma unroll
        for (int mt = 0; mt < kM; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) m[mt][r] = __fmul_rn(sgn * quad_max(m[mt][r]), scale);
      }
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = __fmul_rn(s[mt][n][e], scale);
      mask(k0, kNegInf);
      // p against the exact row maximum; a masked key's p is exactly 0.
      // The choice of exp2 or exp is made once per tile.
      auto softmax = [&](auto exp_fn) {
#pragma unroll
        for (int mt = 0; mt < kM; ++mt)
#pragma unroll
          for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = exp_fn(__fsub_rn(s[mt][n][e], m[mt][e >> 1]));
              l[mt][e >> 1] += p;
              s[mt][n][e] = p;
            }
      };
      if (use_exp2)
        softmax([](float x) { return exp2_ftz(x); });
      else
        softmax([](float x) { return expf(x); });
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        unsigned pa[kM][4], pl[kM][4];
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
          const float(&p0)[4] = s[mt][2 * j];
          const float(&p1)[4] = s[mt][2 * j + 1];
          pa[mt][0] = pack_bf16x2(p0[0], p0[1]);
          pa[mt][1] = pack_bf16x2(p0[2], p0[3]);
          pa[mt][2] = pack_bf16x2(p1[0], p1[1]);
          pa[mt][3] = pack_bf16x2(p1[2], p1[3]);
          if constexpr (kParts == 2) {  // p = hi + lo, unrounded as v is f32
            auto lo = [](float x) { return x - __bfloat162float(__float2bfloat16_rn(x)); };
            pl[mt][0] = pack_bf16x2(lo(p0[0]), lo(p0[1]));
            pl[mt][1] = pack_bf16x2(lo(p0[2]), lo(p0[3]));
            pl[mt][2] = pack_bf16x2(lo(p1[0]), lo(p1[1]));
            pl[mt][3] = pack_bf16x2(lo(p1[2]), lo(p1[3]));
          }
        }
#pragma unroll
        for (int np = 0; np < kD / 16; ++np) {
          const int off = (j * 16 + (mi & 1) * 8 + mr) * kLd + np * 16 + (mi >> 1) * 8;
          unsigned vb[4];
          ldmatrix_x4_trans(vb, vs + off);
          if constexpr (kParts == 2) {
            unsigned vl[4];
            ldmatrix_x4_trans(vl, vs + kT + off);
#pragma unroll
            for (int mt = 0; mt < kM; ++mt) {
              mma_bf16(o[mt][2 * np], pl[mt], vb[0], vb[1]);
              mma_bf16(o[mt][2 * np], pa[mt], vl[0], vl[1]);
              mma_bf16(o[mt][2 * np + 1], pl[mt], vb[2], vb[3]);
              mma_bf16(o[mt][2 * np + 1], pa[mt], vl[2], vl[3]);
            }
          }
#pragma unroll
          for (int mt = 0; mt < kM; ++mt) {
            mma_bf16(o[mt][2 * np], pa[mt], vb[0], vb[1]);
            mma_bf16(o[mt][2 * np + 1], pa[mt], vb[2], vb[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) denom[r] = fmaxf(quad_sum(l[mt][r]), 1e-30f);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      if (n >= n_vt) continue;
      const int col = n * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + (warp * kM + mt) * 16 + g + r * 8;
        if (row >= seq_pad) continue;
        const size_t idx = ((size_t)b * seq_pad + row) * heads * dh + (size_t)h * dh + col;
        store_pair<T, kQuantOut>(out, idx, __fdiv_rn(o[mt][n][2 * r], denom[r]),
                                 __fdiv_rn(o[mt][n][2 * r + 1], denom[r]), out_inv);
      }
    }
  }
}

// bf16 takes two m-tiles per warp (128-row blocks); f32, whose hi and lo
// tiles double the registers and shared memory, one
template <typename T, bool kQuantOut, int kD>
int launch_mma(int batch, const void* qkv, void* out, int heads, int seq_pad, int kv_len,
               int dh, float scale, int use_exp2, float out_inv, cudaStream_t stream) {
  constexpr int kParts = sizeof(T) == 4 ? 2 : 1, kM = 3 - kParts;
  // K and V of two stages, and Q, each one (bf16) or two (f32) tiles wide
  constexpr int kSmem = (4 + kM) * kParts * kTileElems<kD> * 2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      encoder_attention_mma_kernel<T, kQuantOut, kD, kM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq_pad + kM * kRows - 1) / (kM * kRows), heads, batch);
  encoder_attention_mma_kernel<T, kQuantOut, kD, kM><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(qkv), out, heads, seq_pad, kv_len, dh, scale, use_exp2,
      out_inv);
  return (int)cudaGetLastError();
}

template <typename T, bool kQuantOut>
int launch(const void* qkv, void* out, int batch, int heads, int seq_pad, int kv_len, int dh,
           float scale, int use_exp2, float out_inv, cudaStream_t stream) {
  if (dh <= 80)
    return launch_mma<T, kQuantOut, 80>(batch, qkv, out, heads, seq_pad, kv_len, dh, scale,
                                        use_exp2, out_inv, stream);
  return launch_mma<T, kQuantOut, 128>(batch, qkv, out, heads, seq_pad, kv_len, dh, scale,
                                       use_exp2, out_inv, stream);
}

template <typename T>
int dispatch(int quant_out, const void* qkv, void* out, int batch, int heads, int seq_pad,
             int kv_len, int dh, float scale, int use_exp2, float out_inv, cudaStream_t s) {
  if (quant_out)
    return launch<T, true>(qkv, out, batch, heads, seq_pad, kv_len, dh, scale, use_exp2,
                           out_inv, s);
  return launch<T, false>(qkv, out, batch, heads, seq_pad, kv_len, dh, scale, use_exp2,
                          out_inv, s);
}

}  // namespace
}  // namespace gvl

// qkv [B * Sp, 3 * H * dh] (in_dtype: 0 f32, 1 bf16), out [B * Sp, H * dh]
// int8 when quant_out else qkv's type.  dh <= 128 and a multiple of 8;
// 1 <= kv_len <= Sp.  scale multiplies q . k (it carries log2 e when
// use_exp2).  Returns a cudaError_t.
extern "C" int gvl_encoder_attention(const void* qkv, void* out, int batch, int heads,
                                     int seq_pad, int kv_len, int dh, float scale,
                                     int use_exp2, int quant_out, float out_inv, int in_dtype,
                                     void* stream) {
  using namespace gvl;
  if (batch <= 0 || heads <= 0 || seq_pad <= 0 || kv_len <= 0 || kv_len > seq_pad ||
      dh <= 0 || dh > D || dh % 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32)
    return dispatch<float>(quant_out, qkv, out, batch, heads, seq_pad, kv_len, dh, scale, use_exp2, out_inv, s);
  if (in_dtype == kBF16)
    return dispatch<__nv_bfloat16>(quant_out, qkv, out, batch, heads, seq_pad, kv_len, dh, scale, use_exp2, out_inv, s);
  return (int)cudaErrorInvalidValue;
}
