// Encoder self-attention read straight out of a packed QKV projection, for
// Hopper (sm_90a): qkv [B * Sp, 3 * H * dh] (f32 or bf16; q, k, v of head h
// at columns h dh, (H + h) dh, (2H + h) dh), keys at or past kv_len masked,
// out [B * Sp, H * dh] in qkv's type or, with a fused static requantize,
// int8 (clip(round(o * out_inv), 127)).
//
// Replaces three TPU kernels of gvl_tpu/ops/quant_matmul.py, one body:
// - attention_fused_qkv_pallas (Pallas body _padded_attn_kernel): heads
//   padded to dh 128 (the pad columns are data here: all 128 are computed),
//   softmax in exp2 form (the scale carries log2 e), optional requantize,
//   optional int8_scores;
// - attention_packed_multihead_pallas (_packed_mh_attn_kernel): the same
//   math on unpadded heads (dh 72 in so400m);
// - attention_qkv_packed_pallas (_packed_attn_kernel): unpadded heads,
//   softmax with exp, output in qkv's type.
// With int8_scores (the padded kernel's option) q is quantized per q block
// of block_q rows, k and v over their whole [Sp, dh] slab (padded rows
// included), each by its own max |x| / 127 (slab_amax_kernel writes those
// maxima first); the score is the exact integer q8 . k8 times the scales,
// and p is quantized as round(p * 127) against the exact row maximum, so
// that P V is an exact integer sum as in the TPU kernel.
//
// Semantics that fix the design.  p is formed against each row's exact
// maximum and rounded to v's type (bf16, or int8 with int8_scores) before
// P V, and the denominator sums the unrounded p, as the TPU body does.  An
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
// - int8_scores: m16n8k32 s8 products with exact s32 sums for q8 k8^T and
//   p8 v8.  K8 tiles are stored key-major, V8 transposed; p8 leaves the
//   score fragments with its keys permuted within each 32-key step (the
//   accumulator holds keys 2t, 2t + 1 of each 8-key tile, the s8 A fragment
//   wants 4t .. 4t + 3), and the V8 fragment is gathered in the same order,
//   so the integer sum is unchanged.  Tiles are quantized on load (no
//   cp.async); this path serves tests and the chip check only.
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
constexpr int kLd8 = D + 16;        // bytes per int8 row (q8, k8)
constexpr int kLdT8 = kBK + 16;     // bytes per transposed v8 row

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

// columns col, col + 1 of one output row
template <typename T, bool kQuantOut>
__device__ __forceinline__ void store_pair(void* __restrict__ out, size_t idx, float a,
                                           float b, float out_inv) {
  if constexpr (kQuantOut) {
    char2 v;
    v.x = quant_int8(a, out_inv);
    v.y = quant_int8(b, out_inv);
    *reinterpret_cast<char2*>(static_cast<signed char*>(out) + idx) = v;
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<T*>(out) + idx) =
        __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(static_cast<T*>(out) + idx) = make_float2(a, b);
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

// 8 elements of a row quantized by inv to int8
template <typename T>
__device__ __forceinline__ void load_quant8(const T* __restrict__ src, bool valid,
                                            float inv, signed char (&q)[8]) {
  float x[8];
  if (valid) {
    load_f32<T, 8>(src, x);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) q[e] = quant_int8(x[e], inv);
}

// int8_scores: exact integer q8 k8^T and p8 v8 on the s8 tensor cores
template <typename T, bool kQuantOut>
__global__ void __launch_bounds__(kThreads)
encoder_attention_int8_kernel(const T* __restrict__ qkv, void* __restrict__ out,
                              const float* __restrict__ amax, int heads, int seq_pad,
                              int kv_len, int dh, float scale, int use_exp2,
                              float out_inv, int block_q, int n_qblocks) {
  __shared__ __align__(16) signed char q8s[kRows][kLd8];
  __shared__ __align__(16) signed char k8s[2][kBK][kLd8];
  __shared__ __align__(16) signed char v8t[2][D][kLdT8];  // [column][key]

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kRows;
  const int width = 3 * heads * dh;
  const T* base = qkv + (size_t)b * seq_pad * width;
  const int qcol = h * dh, kcol = (heads + h) * dh, vcol = (2 * heads + h) * dh;
  const int dk = (dh + 31) & ~31;  // depth of q8 k8^T, zero-filled past dh
  const int n_vt = dh / 8;
  const int n_tiles = (kv_len + kBK - 1) / kBK;

  const float* am = amax + ((size_t)b * heads + h) * (n_qblocks + 2);
  const float ak = am[n_qblocks], av = am[n_qblocks + 1];
  const float inv_k = __fdiv_rn(127.f, ak), inv_v = __fdiv_rn(127.f, av);
  const float v_scale = __fdiv_rn(__fdiv_rn(av, 127.f), 127.f);
  float s_scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(q0 + warp * 16 + g + r * 8, seq_pad - 1);
    const float aq = am[row / block_q];
    s_scale[r] = __fmul_rn(__fmul_rn(__fdiv_rn(aq, 127.f), __fdiv_rn(ak, 127.f)), scale);
  }

  for (int i = threadIdx.x; i < kRows * (dk / 8); i += kThreads) {
    const int r = i / (dk / 8), c = (i % (dk / 8)) * 8;
    const int row = min(q0 + r, seq_pad - 1);
    const bool valid = q0 + r < seq_pad && c < dh;
    signed char q[8];
    load_quant8<T>(base + (size_t)row * width + qcol + (valid ? c : 0), valid,
                   __fdiv_rn(127.f, am[row / block_q]), q);
    *reinterpret_cast<uint2*>(&q8s[r][c]) = *reinterpret_cast<const uint2*>(q);
  }
  auto load = [&](int it, int stage) {
    const bool second = it >= n_tiles;
    const int k0 = (second ? it - n_tiles : it) * kBK;
    for (int i = threadIdx.x; i < kBK * (dk / 8); i += kThreads) {
      const int j = i / (dk / 8), c = (i % (dk / 8)) * 8;
      const bool valid = k0 + j < kv_len && c < dh;
      const size_t row = (size_t)(valid ? k0 + j : 0) * width + (valid ? c : 0);
      signed char q[8];
      load_quant8<T>(base + row + kcol, valid, inv_k, q);
      *reinterpret_cast<uint2*>(&k8s[stage][j][c]) = *reinterpret_cast<const uint2*>(q);
      if (second && c < dh) {
        load_quant8<T>(base + row + vcol, valid, inv_v, q);
#pragma unroll
        for (int e = 0; e < 8; ++e) v8t[stage][c + e][j] = q[e];
      }
    }
  };
  load(0, 0);

  int o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0;
  unsigned qa[D / 32][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int stage = it & 1;
    const bool second = it >= n_tiles;
    const int k0 = (second ? it - n_tiles : it) * kBK;
    __syncthreads();  // tile it is in shared memory
    if (it == 0) {
      const int r = warp * 16 + g;
#pragma unroll
      for (int ks = 0; ks < D / 32; ++ks) {
        if (ks * 32 >= dk) continue;
        qa[ks][0] = *reinterpret_cast<const unsigned*>(&q8s[r][ks * 32 + 4 * t]);
        qa[ks][1] = *reinterpret_cast<const unsigned*>(&q8s[r + 8][ks * 32 + 4 * t]);
        qa[ks][2] = *reinterpret_cast<const unsigned*>(&q8s[r][ks * 32 + 16 + 4 * t]);
        qa[ks][3] = *reinterpret_cast<const unsigned*>(&q8s[r + 8][ks * 32 + 16 + 4 * t]);
      }
    }
    if (it + 1 < 2 * n_tiles) load(it + 1, stage ^ 1);  // the other stage

    int si[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) si[n][e] = 0;
#pragma unroll
    for (int ks = 0; ks < D / 32; ++ks) {
      if (ks * 32 >= dk) continue;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const unsigned kb[2] = {
            *reinterpret_cast<const unsigned*>(&k8s[stage][n * 8 + g][ks * 32 + 4 * t]),
            *reinterpret_cast<const unsigned*>(&k8s[stage][n * 8 + g][ks * 32 + 16 + 4 * t])};
        mma_s8(si[n], qa[ks], kb);
      }
    }
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = k0 + n * 8 + 2 * t + (e & 1) < kv_len
                      ? __fmul_rn(__int2float_rn(si[n][e]), s_scale[e >> 1])
                      : kNegInf;

    if (!second) {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[n][e]);
    } else {
      if (it == n_tiles) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      }
      int p8[kBK / 8][4];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float arg = __fsub_rn(s[n][e], m[e >> 1]);
          const float p = use_exp2 ? exp2f(arg) : expf(arg);
          l[e >> 1] += p;
          p8[n][e] = __float2int_rn(__fmul_rn(p, 127.f));
        }
      // 32 keys per product; A byte 4t + i holds key 2t, 2t + 1, 2t + 8,
      // 2t + 9 (+16 for a2, a3), and the V8 fragment follows that order
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j) {
        const int n = 4 * j;
        const unsigned pa[4] = {
            pack_s8x4(p8[n][0], p8[n][1], p8[n + 1][0], p8[n + 1][1]),
            pack_s8x4(p8[n][2], p8[n][3], p8[n + 1][2], p8[n + 1][3]),
            pack_s8x4(p8[n + 2][0], p8[n + 2][1], p8[n + 3][0], p8[n + 3][1]),
            pack_s8x4(p8[n + 2][2], p8[n + 2][3], p8[n + 3][2], p8[n + 3][3])};
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          if (nt >= n_vt) continue;
          const unsigned short* vrow =
              reinterpret_cast<const unsigned short*>(&v8t[stage][nt * 8 + g][0]);
          const int key = 32 * j + 2 * t;
          const unsigned vb[2] = {
              vrow[key / 2] | (static_cast<unsigned>(vrow[key / 2 + 4]) << 16),
              vrow[key / 2 + 8] | (static_cast<unsigned>(vrow[key / 2 + 12]) << 16)};
          mma_s8(o[nt], pa, vb);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) denom[r] = fmaxf(quad_sum(l[r]), 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (n >= n_vt) continue;
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + r * 8;
      if (row >= seq_pad) continue;
      const size_t idx = ((size_t)b * seq_pad + row) * heads * dh + (size_t)h * dh + col;
      const float a = __fmul_rn(__int2float_rn(o[n][2 * r]), v_scale);
      const float c = __fmul_rn(__int2float_rn(o[n][2 * r + 1]), v_scale);
      store_pair<T, kQuantOut>(out, idx, __fdiv_rn(a, denom[r]), __fdiv_rn(c, denom[r]),
                               out_inv);
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
int launch(const void* qkv, void* out, const void* amax, int batch, int heads,
           int seq_pad, int kv_len, int dh, float scale, int use_exp2, float out_inv,
           int int8_scores, int block_q, cudaStream_t stream) {
  if (int8_scores) {
    const dim3 grid((seq_pad + kRows - 1) / kRows, heads, batch);
    const int n_qblocks = seq_pad / block_q;
    slab_amax_kernel<T><<<dim3(n_qblocks + 2, heads, batch), 256, 0, stream>>>(
        static_cast<const T*>(qkv), static_cast<float*>(const_cast<void*>(amax)),
        heads, seq_pad, dh, block_q, n_qblocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    encoder_attention_int8_kernel<T, kQuantOut><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(qkv), out, static_cast<const float*>(amax), heads,
        seq_pad, kv_len, dh, scale, use_exp2, out_inv, block_q, n_qblocks);
    return (int)cudaGetLastError();
  }
  if (dh <= 80)
    return launch_mma<T, kQuantOut, 80>(batch, qkv, out, heads, seq_pad, kv_len, dh, scale,
                                        use_exp2, out_inv, stream);
  return launch_mma<T, kQuantOut, 128>(batch, qkv, out, heads, seq_pad, kv_len, dh, scale,
                                       use_exp2, out_inv, stream);
}

template <typename T>
int dispatch(int quant_out, int int8_scores, const void* qkv, void* out,
             const void* amax, int batch, int heads, int seq_pad, int kv_len,
             int dh, float scale, int use_exp2, float out_inv, int block_q,
             cudaStream_t s) {
  if (quant_out)
    return launch<T, true>(qkv, out, amax, batch, heads, seq_pad, kv_len, dh, scale,
                           use_exp2, out_inv, int8_scores, block_q, s);
  return launch<T, false>(qkv, out, amax, batch, heads, seq_pad, kv_len, dh, scale,
                          use_exp2, out_inv, int8_scores, block_q, s);
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
