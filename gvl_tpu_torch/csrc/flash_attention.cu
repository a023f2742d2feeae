// Flash-attention forward for Hopper (sm_90a), f32 or bf16, head_dim 64, 80,
// 128 or 192 (80: SigLIP so400m's 72, and 192: HiCo's 176, each zero-padded by
// the wrapper to the next of these sizes).
//
// Replaces the TPU kernel gvl_tpu/ops/attention.py:flash_attention (Pallas
// bodies _attn_kernel and _attn_single_kernel): softmax(q k^T * scale) v with
// an online softmax, grouped-query heads (KV head = h / group), a causal mask
// aligned to the top left (row i sees keys j <= i) and a key-padding mask
// (keys >= kv_len, on every key).  Masked scores are -1e30; the softmax
// weights are rounded to the input type before P V and the denominator sums
// them unrounded; a row with no live key gives 0.  One kernel covers both
// Pallas branches: a sequence whose keys fit one tile simply runs one loop
// step.
//
// Design.  Tensor cores through mma.sync (csrc/mma.cuh): m16n8k16 bf16
// products with f32 sums.  One block of 4 warps takes 64 kM query rows of one
// head, each warp kM 16-row m-tiles (kM = 2: every K or V fragment read from
// shared memory feeds two products).  K and V pass through a cp.async ring
// of 16-byte copies in
// shared memory (rows D + 8 bf16 wide, an odd number of 16-byte units, so
// ldmatrix reads hit distinct banks).  Keys at or past the block's last live
// key are zero-filled on load and tiles past it are never read, so a NaN past
// kv_len cannot reach P V.  The score fragments, rounded pairwise to bf16,
// are the A fragments of P V (FlashAttention-2's register reuse); the
// running max, denominator and output stay in registers.  Under the causal
// mask the position tiles that see the most keys are scheduled first, a
// warp skips tiles past its last row, and the mask is applied only on tiles
// that reach past a warp's first row or past kv_len; every exp is computed
// and then selected, so no lane branches around it.
// - bf16 (the 8B prefill, the SigLIP tower and its MAP head): one product
//   each for q k^T and P V.
// - f32 (the QA model's prefill): K and V tiles land in f32 staging buffers
//   (cp.async) and are split once per tile into bf16 hi + lo tiles that all
//   warps share; q is split on load.  q k^T is hi.hi + hi.lo + lo.hi and P V
//   the same with p split (lo.lo is ~2^-16 relative): f32-level error.  The
//   staging leaves one block per SM at D 64, so there the block has two key
//   groups of 4 warps: group 1 takes the second half of every tile with its
//   own online softmax and hands its max, denominator and output to group 0
//   at the end (8 warps per SM instead of 4).
//
// Bound.  At the QA model's prefill (10 heads, 4096 tokens, D 64, causal)
// the minimal work is 4 D flops per live (query, key) pair, 21.5 GFLOP per
// layer, 0.0217 ms at the bf16 tensor-core peak (989 TFLOP/s), against
// ~31 MB of traffic: operation-bound.  The f32 split triples the products,
// mma.sync issued from registers reaches a fraction of the peak, and the
// causal work is uneven (the last position tile walks all 4096 keys in
// series).  A wgmma design would run a 64-row warpgroup's products
// asynchronously from shared memory, fed by TMA from a producer warp.
#include "mma.cuh"

namespace gvl {
namespace {

constexpr int kWarps = 4;  // warps of one key group: 16 kM query rows each

// m-tiles per warp, keys per tile, ring stages and key groups for each type
// and head size.  An f32 block needs staging, hi and lo tiles: at D 64 and
// 80 that leaves one block per SM, so two key groups of 4 warps split each
// tile's keys (8 warps per SM); at D 128 one m-tile per warp and 32-key
// tiles keep it within shared memory and registers.  The bf16 blocks fit
// two or three to an SM, and their registers would not take a second key
// group.  D 192 (HiCo's 176 padded; 9 % of padding against 45 % at the TPU
// kernel's 256) takes one m-tile per warp at either type: the output alone is
// 96 f32 registers a lane, and two m-tiles would spill.  Its f32 block holds
// 196 KB of shared memory (Q hi/lo 50, K/V hi/lo 50 at 32-key tiles, the
// staging ring 96), one block per SM; at 256 the same tiles would need
// 260 KB, past the 227 KB a block may hold.
template <typename T, int D>
struct Tiles;
template <>
struct Tiles<float, 64> { static constexpr int kM = 2, kBK = 64, kSt = 2, kGroups = 2; };
template <>
struct Tiles<float, 80> { static constexpr int kM = 2, kBK = 64, kSt = 2, kGroups = 2; };
template <>
struct Tiles<float, 128> { static constexpr int kM = 1, kBK = 32, kSt = 2, kGroups = 1; };
template <>
struct Tiles<float, 192> { static constexpr int kM = 1, kBK = 32, kSt = 2, kGroups = 1; };
template <>
struct Tiles<__nv_bfloat16, 64> { static constexpr int kM = 2, kBK = 64, kSt = 3, kGroups = 1; };
template <>
struct Tiles<__nv_bfloat16, 80> { static constexpr int kM = 2, kBK = 64, kSt = 3, kGroups = 1; };
template <>
struct Tiles<__nv_bfloat16, 128> { static constexpr int kM = 2, kBK = 64, kSt = 2, kGroups = 1; };
template <>
struct Tiles<__nv_bfloat16, 192> { static constexpr int kM = 1, kBK = 64, kSt = 2, kGroups = 1; };

template <typename T, int D>
constexpr int kThreadsOf = 32 * kWarps * Tiles<T, D>::kGroups;

template <typename T, int D>
constexpr int kRowsOf = 16 * kWarps * Tiles<T, D>::kM;  // query rows per block

// shared memory, bytes: the Q tile(s), then for bf16 the K/V ring, for f32
// the K and V hi and lo tiles and the f32 staging ring
template <typename T, int D>
constexpr int kSmemBytes =
    sizeof(T) == 4
        ? 2 * kRowsOf<T, D> * (D + 8) * 2 + 4 * Tiles<T, D>::kBK * (D + 8) * 2 +
              Tiles<T, D>::kSt * 2 * Tiles<T, D>::kBK * D * 4
        : kRowsOf<T, D> * (D + 8) * 2 + Tiles<T, D>::kSt * 2 * Tiles<T, D>::kBK * (D + 8) * 2;

// x - bf16(x): the lo half of x's split
__device__ __forceinline__ float lo_part(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsOf<T, D>)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
                       int sq, int sk, int kv_len, int causal, float scale) {
  constexpr int kM = Tiles<T, D>::kM, kBK = Tiles<T, D>::kBK, kSt = Tiles<T, D>::kSt;
  constexpr int kGroups = Tiles<T, D>::kGroups;
  constexpr int kThreads = kThreadsOf<T, D>;
  constexpr int kBKg = kBK / kGroups;  // keys of a tile for one key group
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kParts = kF32 ? 2 : 1;  // bf16 hi (and lo)
  constexpr int kLd = D + 8;
  constexpr int kRows = kRowsOf<T, D>;
  constexpr int kTile = kBK * kLd;   // bf16 per K or V tile
  constexpr int kQTile = kRows * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q part p at qs + p kQTile.  bf16: K of stage s at kv + 2 s kTile, V at
  // kv + (2 s + 1) kTile.  f32: K hi, K lo, V hi, V lo at kv + i kTile, and
  // the f32 K (V) of stage s at staging + (2 s (+ 1)) kBK D.
  __nv_bfloat16* const qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* const kv = qs + kParts * kQTile;
  float* const staging = reinterpret_cast<float*>(kv + 4 * kTile);

  const int h = blockIdx.x, b = blockIdx.y;
  const int s0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // longest first
  const int kvh = h / (hq / hkv);
  const int warp = threadIdx.x / 32 % kWarps, kg = threadIdx.x / 32 / kWarps;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, mi = lane / 8, mr = lane % 8;
  const int kv_end = max(0, min(kv_len, sk));
  const float scale_log2 = scale * kLog2e;  // scores in log2 units: exp is exp2
  // keys the block's last stored row sees: the end of the key loop
  const int kend = causal ? min(kv_end, min(s0 + kRows, sq)) : kv_end;
  const int n_tiles = (kend + kBK - 1) / kBK;

  // this warp's rows: positions w_first .. w_first + 16 kM - 1, m-tile mt
  // from pos0[mt]; the keys each of this lane's rows sees end at row_end
  const int w_first = s0 + 16 * kM * warp;
  const int w_last = min(w_first + 16 * kM - 1, sq - 1);
  int pos0[kM], row_end[kM][2];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
    pos0[mt] = w_first + 16 * mt;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      row_end[mt][r] = causal ? min(pos0[mt] + g + 8 * r + 1, kv_end) : kv_end;
  }
  const bool warp_live = w_first < sq;
  // keys the warp's first row sees (tiles before that end need no mask) and
  // its last row sees (tiles from there on are skipped)
  const int w_first_end = causal ? min(w_first + 1, kv_end) : kv_end;
  const int w_last_end = causal ? min(w_last + 1, kv_end) : kv_end;

  // the block's query rows into the Q tile(s)
  for (int i = threadIdx.x; i < kRows * (D / 8); i += kThreads) {
    const int rr = i / (D / 8), c = (i % (D / 8)) * 8;
    const int pos = s0 + rr;
    const bool valid = pos < sq;
    const T* src = q + (((size_t)b * hq + h) * sq + (valid ? pos : 0)) * D + c;
    if constexpr (!kF32) {
      cp_async16(qs + rr * kLd + c, src, valid);
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
      *reinterpret_cast<uint4*>(qs + rr * kLd + c) = *reinterpret_cast<const uint4*>(hi);
      *reinterpret_cast<uint4*>(qs + kQTile + rr * kLd + c) =
          *reinterpret_cast<const uint4*>(lo);
    }
  }
  const size_t kv_off = ((size_t)b * hkv + kvh) * sk * D;
  // the K and V tiles of step it into a stage of the ring (bf16: the tiles
  // themselves; f32: the staging buffers)
  auto load = [&](int it, int stage) {
    constexpr int kUnit = 16 / sizeof(T);  // elements per 16-byte copy
    for (int i = threadIdx.x; i < kBK * (D / kUnit); i += kThreads) {
      const int j = i / (D / kUnit), c = (i % (D / kUnit)) * kUnit;
      const int key = it * kBK + j;
      const bool valid = key < kend;
      const size_t off = kv_off + (size_t)(valid ? key : 0) * D + c;
      if constexpr (kF32) {
        cp_async16(staging + (2 * stage * kBK + j) * D + c, k + off, valid);
        cp_async16(staging + ((2 * stage + 1) * kBK + j) * D + c, v + off, valid);
      } else {
        cp_async16(kv + 2 * stage * kTile + j * kLd + c, k + off, valid);
        cp_async16(kv + (2 * stage + 1) * kTile + j * kLd + c, v + off, valid);
      }
    }
  };
  // one commit group per tile (the first also holds a bf16 Q), empty past
  // the end
#pragma unroll
  for (int st = 0; st < kSt - 1; ++st) {
    if (st < n_tiles) load(st, st);
    cp_async_commit();
  }

  float o[kM][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) m[mt][r] = kNegInf, l[mt][r] = 0.f;
  // this lane's ldmatrix row in the Q tiles: warp rows 16 kM warp + 16 mt
  const int qrow = (warp * kM * 16 + (mi & 1) * 8 + mr) * kLd + (mi >> 1) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kSt, k0 = it * kBK + kg * kBKg;  // this group's keys
    cp_async_wait<kSt - 2>();  // tile it has landed
    __syncthreads();           // ... for every thread; tile it - 1 is consumed
    if (it + kSt - 1 < n_tiles) load(it + kSt - 1, (it + kSt - 1) % kSt);
    cp_async_commit();
    const __nv_bfloat16 *khi, *vhi;
    if constexpr (kF32) {
      // split the staged f32 tiles once, for all warps
      for (int i = threadIdx.x; i < 2 * kBK * (D / 4); i += kThreads) {
        const int which = i / (kBK * (D / 4)), j = i / (D / 4) % kBK, c = (i % (D / 4)) * 4;
        const float4 x =
            *reinterpret_cast<const float4*>(staging + ((2 * stage + which) * kBK + j) * D + c);
        __align__(8) __nv_bfloat16 hi[4], lo[4];
        split_bf16(x.x, hi[0], lo[0]);
        split_bf16(x.y, hi[1], lo[1]);
        split_bf16(x.z, hi[2], lo[2]);
        split_bf16(x.w, hi[3], lo[3]);
        __nv_bfloat16* dst = kv + 2 * which * kTile + j * kLd + c;
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(hi);
        *reinterpret_cast<uint2*>(dst + kTile) = *reinterpret_cast<const uint2*>(lo);
      }
      __syncthreads();
      khi = kv;
      vhi = kv + 2 * kTile;
    } else {
      khi = kv + 2 * stage * kTile;
      vhi = kv + (2 * stage + 1) * kTile;
    }
    if (!warp_live || k0 >= w_last_end) continue;

    // s = q k^T for this warp's 16 kM rows and the tile's keys
    float s[kM][kBKg / 8][4];
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int n = 0; n < kBKg / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned qa[kParts][kM][4];
#pragma unroll
      for (int p = 0; p < kParts; ++p)
#pragma unroll
        for (int mt = 0; mt < kM; ++mt)
          ldmatrix_x4(qa[p][mt], qs + p * kQTile + qrow + mt * 16 * kLd + kk * 16);
#pragma unroll
      for (int np = 0; np < kBKg / 16; ++np) {
        const int off =
            (kg * kBKg + np * 16 + (mi >> 1) * 8 + mr) * kLd + kk * 16 + (mi & 1) * 8;
        unsigned kb[4];
        ldmatrix_x4(kb, khi + off);
        if constexpr (kF32) {
          unsigned kl[4];
          ldmatrix_x4(kl, khi + kTile + off);  // the lo tile follows
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

    // scale (times log2 e); mask only on a tile that reaches past the end of
    // the warp's first row (the causal diagonal or kv_len)
    const bool masked = k0 + kBKg > w_first_end;
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int n = 0; n < kBKg / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = !masked || k0 + n * 8 + 2 * t + (e & 1) < row_end[mt][e >> 1];
          s[mt][n][e] = live ? s[mt][n][e] * scale_log2 : kNegInf;
        }
    // online softmax in exp2 form (one MUFU.EX2 a weight): a masked key adds
    // nothing; exp2 is taken for every key and then selected, so that no
    // lane branches around it
#pragma unroll
    for (int mt = 0; mt < kM; ++mt) {
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < kBKg / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * r], s[mt][n][2 * r + 1]));
        const float m_new = fmaxf(m[mt][r], quad_max(mx));
        alpha[r] = exp2_ftz(m[mt][r] - m_new);
        m[mt][r] = m_new;
        l[mt][r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] *= alpha[e >> 1];
#pragma unroll
      for (int n = 0; n < kBKg / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = exp2_ftz(s[mt][n][e] - m[mt][e >> 1]);
          const float p = s[mt][n][e] == kNegInf ? 0.f : ex;
          l[mt][e >> 1] += p;
          s[mt][n][e] = p;
        }
    }

    // o += p v: bf16 p (rounded as the input type), or p = hi + lo for f32
#pragma unroll
    for (int j = 0; j < kBKg / 16; ++j) {
      unsigned pa[kM][4], pl[kM][4];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        const float(&p0)[4] = s[mt][2 * j];
        const float(&p1)[4] = s[mt][2 * j + 1];
        pa[mt][0] = pack_bf16x2(p0[0], p0[1]);
        pa[mt][1] = pack_bf16x2(p0[2], p0[3]);
        pa[mt][2] = pack_bf16x2(p1[0], p1[1]);
        pa[mt][3] = pack_bf16x2(p1[2], p1[3]);
        if constexpr (kF32) {
          pl[mt][0] = pack_bf16x2(lo_part(p0[0]), lo_part(p0[1]));
          pl[mt][1] = pack_bf16x2(lo_part(p0[2]), lo_part(p0[3]));
          pl[mt][2] = pack_bf16x2(lo_part(p1[0]), lo_part(p1[1]));
          pl[mt][3] = pack_bf16x2(lo_part(p1[2]), lo_part(p1[3]));
        }
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        const int off =
            (kg * kBKg + j * 16 + (mi & 1) * 8 + mr) * kLd + np * 16 + (mi >> 1) * 8;
        unsigned vb[4];
        ldmatrix_x4_trans(vb, vhi + off);
        if constexpr (kF32) {
          unsigned vl[4];
          ldmatrix_x4_trans(vl, vhi + kTile + off);
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
  cp_async_wait<0>();  // a bf16 Q copied for a block with no live key

  // key group 1 hands its running max, denominator and output to group 0
  // through the (now idle) K/V tiles, laid out so that lanes hit distinct
  // banks
  if constexpr (kGroups == 2) {
    constexpr int kVals = kM * (4 + D / 2);
    static_assert(kVals * kWarps * 32 * 4 <= 4 * kTile * 2, "the hand-over fits the tiles");
    float* xch = reinterpret_cast<float*>(kv);
    auto slot = [&](int i) { return xch + (i * kWarps + warp) * 32 + lane; };
    __syncthreads();
    if (kg == 1) {
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *slot(mt * 4 + r) = m[mt][r];
          *slot(mt * 4 + 2 + r) = l[mt][r];
        }
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) *slot(kM * 4 + (mt * (D / 8) + n) * 4 + e) = o[mt][n][e];
    }
    __syncthreads();
    if (kg == 1) return;
#pragma unroll
    for (int mt = 0; mt < kM; ++mt) {
      float a0[2], a1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = *slot(mt * 4 + r), m_new = fmaxf(m[mt][r], m1);
        a0[r] = exp2_ftz(m[mt][r] - m_new);
        a1[r] = exp2_ftz(m1 - m_new);
        l[mt][r] = l[mt][r] * a0[r] + *slot(mt * 4 + 2 + r) * a1[r];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[mt][n][e] = o[mt][n][e] * a0[e >> 1] +
                        *slot(kM * 4 + (mt * (D / 8) + n) * 4 + e) * a1[e >> 1];
    }
  }

#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[mt][r]);
      const int pos = pos0[mt] + g + 8 * r;
      if (pos >= sq) continue;
      const float denom = fmaxf(sum, 1e-30f);
      T* dst = out + (((size_t)b * hq + h) * sq + pos) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float a = o[mt][n][2 * r] / denom, c = o[mt][n][2 * r + 1] / denom;
        if constexpr (kF32) {
          *reinterpret_cast<float2*>(dst + n * 8) = make_float2(a, c);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(a, c);
        }
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int hq, int hkv, int sq, int sk, int kv_len, int causal,
           float scale, cudaStream_t stream) {
  constexpr int kRows = kRowsOf<T, D>;
  constexpr int kThreads = kThreadsOf<T, D>;
  constexpr int kSmem = kSmemBytes<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(hq, batch, (sq + kRows - 1) / kRows);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, hkv, sq, sk, kv_len, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvl

// q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], out [B, Hq, Sq, D], all contiguous
// and of one type (dtype: 0 f32, 1 bf16).  Returns a cudaError_t.
extern "C" int gvl_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int batch, int hq, int hkv,
                                   int sq, int sk, int head_dim, int kv_len,
                                   int causal, float scale, int dtype,
                                   void* stream) {
  using namespace gvl;
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && head_dim == 64)
    return launch<float, 64>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  if (dtype == kF32 && head_dim == 80)
    return launch<float, 80>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  if (dtype == kF32 && head_dim == 128)
    return launch<float, 128>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  if (dtype == kF32 && head_dim == 192)
    return launch<float, 192>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  if (dtype == kBF16 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  if (dtype == kBF16 && head_dim == 80)
    return launch<__nv_bfloat16, 80>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  if (dtype == kBF16 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  if (dtype == kBF16 && head_dim == 192)
    return launch<__nv_bfloat16, 192>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
