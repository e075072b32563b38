// Kernel K4: sliding-window ragged chunk prefill for Hopper (sm_90a).  A
// batch of prompt chunks, row b holding T queries at absolute positions
// start[b] + t (the first n_live[b] real, the rest padding), each attending
// two key sources in one softmax: the row's page ring as it stood *before*
// the chunk's writes, and the chunk's own fresh K/V.
//
// Replaces the Pallas TPU kernel repro/kernels/ragged_prefill/kernel.py::
// windowed_ragged_prefill_fwd (_windowed_ragged_prefill_kernel), bf16 ring
// pages or int8 ring pages with bf16 per-token-per-head scales; the fresh
// K/V are bf16 in both modes (never quantized); with or without its logit
// softcap.  Contract:
// repro/kernels/README.md "The ragged-prefill contract" (pre-write pool,
// window > 0) and "Scale-operand layout".  Masks (kernel.py:236-262):
//   ring slot idx (ring = n_ring * ps slots) holds k_abs = last - ((last %
//     ring - idx) mod ring) with last = start - 1, the last position written
//     before the chunk; at start == 0 every slot is negative.  Seen iff
//     k_abs >= 0 and k_abs > q_abs - window;
//   fresh token f (k_abs = start + f) is seen iff f <= t, f < n_live and
//     k_abs > q_abs - window.
// Rows t >= n_live (chunk padding, discarded by the caller) are written as
// exact zeros; the plain version zeroes them too.
//
// What bounds it: operations.  Each (live row, seen key) pair costs 4 * D
// flops (QK^T and PV); at the smoke's shape (starcoder2-7b: B 4 chunks of
// 256, 36 query / 4 KV heads of 128, window 4096, 257-page rings) that is
// 53.8 GFLOP against about 50 MB of ring K/V, q, fresh K/V and out: 0.0544
// ms of bf16 tensor-core time (989 TFLOP/s dense, NVIDIA's data sheet)
// against about 0.015 ms of HBM time (3.35 TB/s), so the products belong on
// the tensor cores.  The TPU body banks a [q_blk * G, (n_ring + n_fresh) *
// ps] fp32 score matrix in VMEM (kernel.py:349), 20 MB at that shape, far
// above the 227 KB of shared memory a Hopper block holds; here the scores
// are recomputed instead (two sweeps), so the tensor cores do 1.5x the
// function's products.
//
// Design: K2's (ragged_prefill.cu; the machinery is ragged_prefill.cuh).
// One warpgroup (128 threads) per (64-row query tile, KV head, request); a
// row is a (token, group head) pair, token-major, so all G heads of a KV
// head share every K/V tile and a token's G rows may straddle two tiles (G
// <= 128).  A tile whose first token is at or past n_live writes zeros and
// exits.  Keys come in 64-slot tiles from two sources, in one key order:
//   ring tiles, anchored at absolute pages: ring tile r holds absolute pages
//     [r * ppt, (r + 1) * ppt) (ppt = 64 / ps pages, kt = ppt * ps slots;
//     slots past kt are zero-filled), page a read from ring slot-page a %
//     n_ring (the row's tables[b, a % n_ring]).  Only pages a in [a_lo,
//     a_hi] are staged, a_hi = (start - 1) / ps and a_lo = max(0, a_hi -
//     n_ring + 1): n_ring consecutive pages, each slot-page once.  A tile's
//     pages below a_lo are zero-filled (cp.async with source size 0): their
//     slot-pages hold pages a + n_ring, whose keys would otherwise count
//     twice.  Each staged slot is masked by the TPU kernel's formula on its
//     slot index, never by a * ps + j: the last page is partial, and its
//     slots past last % ps hold keys one ring older, which only the formula
//     and the window exclude;
//   fresh tiles, anchored at chunk token 0: fresh tile f holds tokens [64 f,
//     64 f + 64) of k_new/v_new [B, T, K, D] (rows at or past n_live are
//     zero-filled).
// Each tile's 64 key positions (a sentinel for zero-filled slots) are
// computed once as it is staged; a slot is seen by a row iff its position
// is in (q_abs - window, q_abs].  Tiles that no live row of the query tile
// sees are skipped: ring pages older than the window of the tile's first
// token, fresh tiles past its last live token.  Only tiles that cross an
// edge -- the window's lower edge (which falls among the fresh keys when
// the window is shorter than the chunk), the fresh diagonal, n_live, the
// ring's partial last page, zero-filled slots -- are masked, element by
// element.  K and V go in shared memory by 16-byte cp.async copies two
// stages deep, so the next tile's copies overlap this tile's products; bf16
// rows land in 128-byte-swizzled 64-column halves.  int8 ring rows land
// raw at the end of their stage's bf16 tile and are widened in place
// (read, the readers meet, write; exact: |k8| <= 127 fits bf16's 8
// significant bits), their bf16 scales beside them: unlike K2, which
// widens into separate tiles, K4's int8 mode needs its stages in bf16 for
// the fresh tiles too, and widening in place keeps it at the bf16 layout's
// 82 KB at D = 128, two blocks an SM.  QK^T is `wgmma.m64n64k16` with Q and
// the K tile from shared memory; PV is `wgmma.m64n64k16` with p from
// registers and V MN-major.
//
// Rounding: one softmax at each row's *true* max, never an online softmax
// of the output (kernel.py:30-36).  Sweep 1 computes every tile's fp32
// scores, the row max m and the normalizer l, rescaling only l; a tile
// fully masked for a row adds exactly 0 to l and leaves m, also before the
// row's first seen key (masked keys never become the row's max).  Sweep 2
// recomputes the scores with the same instructions (the same bits), forms
// p = exp(s - m) / l at the true m and final l, and does PV into fp32.
//   bf16 ring: scores (q . k) * scale, the scale after the dot; p rounded to
//     bf16 (the value dtype, kernel.py:313).
//   softcap > 0: every score, ring or fresh, is capped s = softcap *
//     tanhf(s / softcap) after the scale (kernel.py:250-251 and :263-264)
//     and before the mask, which replaces it (capping a masked score would
//     make its key live at -softcap); one site in the score loop both
//     sweeps run, so sweep 2's p is taken at the max sweep 1 saw; a
//     template flag, so the uncapped instantiations keep their code and
//     registers.  IEEE
//     tanhf, not tanh.approx.f32 (~2^-11 relative error near |s| =
//     softcap, more than a row ulp of p).
//   int8 ring: the ring score is (q . k8) * ks * scale, where the reference
//     takes q . (f32(k8) * f32(ks)) * scale (f32(k8) * f32(ks) is exact, so
//     the two differ only in fp32 rounding); p stays fp32 and goes to the
//     tensor cores as p' = p * vs split into h1 = bf16(p') and h2 = bf16(p'
//     - h1), each times the int8-as-bf16 V tile an exact product into the
//     same fp32 sum (|p' - h1 - h2| <= 2^-17 |p'|, K2's rule).  The fresh
//     K/V are bf16 and the reference promotes them to fp32 beside the
//     dequantized ring (ops.py:70-71), so fresh tiles take ks = vs = 1,
//     which is exact, down the same path.
// One bf16 cast at the output.
//
// Why the ring's length changes no sum: a row's tiles are anchored at
// absolute pages and fresh tokens, and its sums run over them in key order
// (each thread's 16 columns in order, then a fixed shuffle tree over the 4
// threads of the row).  A ring with more pages holding the same window
// stages the same keys at the same slots of the same tiles, plus older
// pages that no row sees: masked, they add exactly 0.  So a ring with the
// speculative pool's slack page equals the plain ring bit for bit, and a
// row's result depends only on its q, its keys and its position, never on
// the rest of its batch.
//
// Numerics: IEEE expf and division (build without --use_fast_math).

#include "ragged_prefill.cuh"

namespace {

constexpr int kNoKey = -2147483647 - 1;   // a zero-filled slot: seen by none

// Shared-memory layout of one instantiation, in bytes from a 1024-aligned
// base: Q, two stages of K and of V (bf16, swizzled; an int8 ring tile
// lands raw in the last 64 * D bytes of its stage's tile), two stages of
// the tiles' key positions; int8 adds two stages of scale words (the
// aligned 32-bit word holding a token's bf16 scale) and which half of the
// word it is, and the tile's K and V scales as fp32.
template <int D, bool kInt8>
struct WLayout {
  static constexpr int kHalves = (D + 63) / 64;
  static constexpr int kTile = kHalves * kHalf;        // a [64][D] bf16 tile
  static constexpr int kRaw = kTile - kSlots * D;      // raw int8 in a tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                     // + stage * kTile
  static constexpr int kV = 3 * kTile;                 // + stage * kTile
  static constexpr int kPos = 5 * kTile;               // [2][64] int32
  static constexpr int kWords = kPos + 2 * kSlots * 4;      // [2][2][64] u32
  static constexpr int kSel = kWords + 2 * 2 * kSlots * 4;  // [2][2][64] u8
  static constexpr int kScaleF = kSel + 2 * 2 * kSlots;     // [2][64] f32
  static constexpr int kBytes = kInt8 ? kScaleF + 2 * kSlots * 4 : kWords;
};

// The ring's geometry for one request: absolute pages a_lo..a_hi are staged
// (none at start 0), page a at slot-page lo_sp + (a - a_lo), wrapped.
struct Ring {
  int last, n_ring, ring, last_slot, a_lo, a_hi, lo_sp;
  __device__ __forceinline__ Ring(int st, int ps, int n) {
    last = st - 1;
    n_ring = n;
    ring = n * ps;
    last_slot = last >= 0 ? last % ring : 0;
    a_hi = last >= 0 ? last / ps : -1;
    a_lo = max(0, a_hi - n + 1);
    lo_sp = a_lo % n;
  }
  __device__ __forceinline__ bool staged(int a) const {
    return a >= a_lo && a <= a_hi;
  }
  __device__ __forceinline__ int slot_page(int a) const {  // a staged
    const int sp = lo_sp + (a - a_lo);
    return sp >= n_ring ? sp - n_ring : sp;
  }
  // the TPU kernel's position of slot j of staged page a, kNoKey if < 0
  __device__ __forceinline__ int position(int a, int j, int ps) const {
    int back = last_slot - (slot_page(a) * ps + j);
    if (back < 0) back += ring;
    const int k_abs = last - back;
    return k_abs >= 0 ? k_abs : kNoKey;
  }
};

// Copy ring tile ``r`` of one pool into a stage: staged pages through the
// row's table, every other slot zero-filled; bf16 rows swizzled, int8 rows
// raw [64][D] at the tile's end.
template <int D, bool kInt8>
__device__ __forceinline__ void issue_ring(uint32_t dst,
                                           const void* __restrict__ pages,
                                           const int32_t* __restrict__ tb,
                                           const KvSlots<D, kInt8>& sl,
                                           const Ring& rg, int r, int ppt,
                                           int ps, int K, int kh) {
  constexpr int kE = kInt8 ? 1 : 2, kC = D * kE / 16;
  const char* base = static_cast<const char*>(pages);
#pragma unroll
  for (int it = 0; it < KvSlots<D, kInt8>::kIt; ++it) {
    const int e = threadIdx.x + it * kThreads, row = e / kC, c = e % kC;
    const int a = r * ppt + sl.page[it];
    const bool ok = sl.page[it] >= 0 && rg.staged(a);
    const char* src =
        base + (((size_t)(ok ? __ldg(tb + rg.slot_page(a)) : 0) * ps
                 + sl.tok[it]) * K + kh) * D * kE + c * 16;
    cp_async16(dst + (kInt8 ? WLayout<D, true>::kRaw + row * D + c * 16
                            : swz(row, c)),
               src, ok ? 16 : 0);
  }
}

// Copy fresh tile rows [f0, f0 + 64) of k_new or v_new (zeros at or past
// n_live) into a stage, swizzled.
template <int D>
__device__ __forceinline__ void issue_fresh(uint32_t dst,
                                            const __nv_bfloat16* __restrict__ fresh,
                                            int b, int f0, int nl, int T,
                                            int K, int kh) {
  constexpr int kC = D / 8;
#pragma unroll
  for (int it = 0; it < kSlots * kC / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / kC, c = e % kC;
    const int f = f0 + r;
    const bool ok = f < nl;
    const __nv_bfloat16* src =
        fresh + (((size_t)b * T + (ok ? f : 0)) * K + kh) * D + c * 8;
    cp_async16(dst + swz(r, c), src, ok ? 16 : 0);
  }
}

// Copy the aligned 32-bit word that holds the bf16 scale of slot ``slot``
// of ring tile ``r`` into ``word`` and note which half of the word it is
// (cp.async copies 4 bytes at least; the word's other half lies inside the
// allocation, which PyTorch rounds up to 512 bytes).  Zero-filled slots
// get scale 0.
__device__ __forceinline__ void issue_ring_scale(
    uint32_t word, uint8_t* sel, const __nv_bfloat16* __restrict__ scales,
    const int32_t* __restrict__ tb, const Ring& rg, int r, int slot,
    int ppt, int kt, int ps, int K, int kh) {
  const int a = r * ppt + slot / ps;
  const bool ok = slot < kt && rg.staged(a);
  const size_t at = ((size_t)(ok ? __ldg(tb + rg.slot_page(a)) : 0) * ps
                     + slot % ps) * K + kh;
  cp_async4(word, reinterpret_cast<const uint32_t*>(scales) + at / 2,
            ok ? 4 : 0);
  *sel = static_cast<uint8_t>(at & 1);
}

// Widen the raw int8 rows at the end of a stage's K tile (and V tile, if
// given) into the swizzled bf16 tile they sit in: every thread reads its
// chunks, the readers of every raw row meet, then every thread writes.  At
// D = 128 raw row r is exactly the bytes of the second half's row r, which
// only the 8 threads that read raw row r write (one warp), so the warp
// meets; at D = 32 and 64 raw rows fall in other warps' rows: the block.
template <int D>
__device__ __forceinline__ void widen_in_place(uint8_t* k, uint8_t* v) {
  constexpr int kC = D / 16, kIt = kSlots * kC / kThreads;
  constexpr int kRaw = WLayout<D, true>::kRaw;
  int4 xk[kIt], xv[kIt];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / kC, c = e % kC;
    xk[it] = *reinterpret_cast<const int4*>(k + kRaw + r * D + c * 16);
    if (v) xv[it] = *reinterpret_cast<const int4*>(v + kRaw + r * D + c * 16);
  }
  if constexpr (kRaw == kHalf && kC == 8)
    __syncwarp();
  else
    __syncthreads();
  auto store = [&](uint8_t* tile, int r, int c, const int4& x) {
    const int8_t* s = reinterpret_cast<const int8_t*>(&x);
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = pack_bf16(static_cast<float>(s[2 * j]),
                       static_cast<float>(s[2 * j + 1]));
    *reinterpret_cast<uint4*>(tile + swz(r, 2 * c)) =
        make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(tile + swz(r, 2 * c + 1)) =
        make_uint4(w[4], w[5], w[6], w[7]);
  };
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / kC, c = e % kC;
    store(k, r, c, xk[it]);
    if (v) store(v, r, c, xv[it]);
  }
}

template <int D, bool kInt8, bool kCap>
__global__ void __launch_bounds__(kThreads)
windowed_prefill_kernel(const __nv_bfloat16* __restrict__ q,      // [B, T, H, D]
                        const __nv_bfloat16* __restrict__ k_new,  // [B, T, K, D]
                        const __nv_bfloat16* __restrict__ v_new,  // [B, T, K, D]
                        const void* __restrict__ k_pages,         // [P, ps, K, D]
                        const void* __restrict__ v_pages,         // [P, ps, K, D]
                        const __nv_bfloat16* __restrict__ k_scale,  // [P, ps, K]
                        const __nv_bfloat16* __restrict__ v_scale,  // [P, ps, K]
                        const int32_t* __restrict__ tables,       // [B, n_ring]
                        const int32_t* __restrict__ start,        // [B]
                        const int32_t* __restrict__ n_live,       // [B]
                        __nv_bfloat16* __restrict__ out,          // [B, T, H, D]
                        int T, int H, int K, int ps, int n_ring, int window,
                        float scale, float softcap) {
  using L = WLayout<D, kInt8>;
  constexpr int kH = L::kHalves;
  // a request's later query tiles are the longer ones: start them first
  const int tile = gridDim.x - 1 - blockIdx.x, kh = blockIdx.y,
            b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int st = start[b];
  const int nl = min(n_live[b], T);
  const int t_first = tile * kRows / G;
  if (t_first >= nl) {                 // the whole tile is chunk padding
    constexpr int kC = D / 8;
    for (int e = tid; e < kRows * kC; e += kThreads) {
      const int row = tile * kRows + e / kC;
      if (row >= T * G) continue;
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * T + row / G) * H + kh * G + row % G) * D
          + (e % kC) * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);

  const int row_last = min(tile * kRows + kRows, T * G) - 1;
  const int t_last = min(row_last / G, nl - 1);       // last live token
  const int q_first = st + t_first, q_last = st + t_last;
  const int lo_key = q_first - window + 1;   // oldest key a live row sees
  const int ppt = kSlots / ps, kt = ppt * ps;
  const Ring rg(st, ps, n_ring);
  // ring tiles r0 .. r0 + n_r - 1 (pages older than lo_key skipped), then
  // fresh tiles f0 .. t_last / 64 (tokens past the last live one skipped)
  const int p_lo = max(rg.a_lo, max(lo_key, 0) / ps);
  const int r0 = p_lo / ppt;
  const int n_r = p_lo <= rg.a_hi ? rg.a_hi / ppt - r0 + 1 : 0;
  const int f0 = max(lo_key - st, 0) / kSlots;
  const int n = n_r + t_last / kSlots - f0 + 1;
  const int32_t* tb = tables + (size_t)b * n_ring;

  // this thread's two accumulator rows: their positions and window edges
  int q_abs[2], q_lo[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    q_abs[e] = st + (tile * kRows + 16 * warp + (lane >> 2) + 8 * e) / G;
    q_lo[e] = q_abs[e] - window;
  }

  // zeros everywhere first: D = 32's unused columns are never copied, and
  // must not hold NaN bits for PV
  for (int e = tid; e < L::kBytes / 16; e += kThreads)
    reinterpret_cast<uint4*>(sm)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // steps 0 .. n-1 are sweep 1 (K only), n .. 2n-1 sweep 2 (K and V)
  const KvSlots<D, kInt8> slots(ps, kt);
  int* kpos = reinterpret_cast<int*>(sm + L::kPos);
  auto issue = [&](int step) {
    const int i = step < n ? step : step - n, stage = step & 1;
    const bool with_v = step >= n;
    const uint32_t k_dst = base + L::kK + stage * L::kTile;
    const uint32_t v_dst = base + L::kV + stage * L::kTile;
    if (i < n_r) {
      const int r = r0 + i;
      if (tid < kSlots) {
        const int a = r * ppt + tid / ps;
        kpos[stage * kSlots + tid] =
            tid < kt && rg.staged(a) ? rg.position(a, tid % ps, ps) : kNoKey;
      }
      issue_ring<D, kInt8>(k_dst, k_pages, tb, slots, rg, r, ppt, ps, K, kh);
      if (with_v)
        issue_ring<D, kInt8>(v_dst, v_pages, tb, slots, rg, r, ppt, ps, K,
                             kh);
      if constexpr (kInt8) {
        uint32_t* words =
            reinterpret_cast<uint32_t*>(sm + L::kWords) + stage * 128;
        uint8_t* sel = sm + L::kSel + stage * 128;
        if (tid < 64 || with_v)
          issue_ring_scale(smem_addr(words + tid), sel + tid,
                           tid < 64 ? k_scale : v_scale, tb, rg, r, tid & 63,
                           ppt, kt, ps, K, kh);
      }
    } else {
      const int f = (f0 + i - n_r) * kSlots;
      if (tid < kSlots)
        kpos[stage * kSlots + tid] = f + tid < nl ? st + f + tid : kNoKey;
      issue_fresh<D>(k_dst, k_new, b, f, nl, T, K, kh);
      if (with_v) issue_fresh<D>(v_dst, v_new, b, f, nl, T, K, kh);
    }
  };

  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  float o[kH][32];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[h][j] = 0.f;
  float s[32];

  issue_q<D>(base + L::kQ, q, b, tile, T, H, G, kh);
  issue(0);
  cp_async_commit();
  for (int step = 0; step < 2 * n; ++step) {
    const int i = step < n ? step : step - n, stage = step & 1;
    const bool sweep2 = step >= n, ring = i < n_r;
    if (step + 1 < 2 * n) issue(step + 1);
    cp_async_commit();
    cp_async_wait1();
    fence_async_smem();
    __syncthreads();

    const uint32_t k_tile = base + L::kK + stage * L::kTile;
    const uint32_t v_tile = base + L::kV + stage * L::kTile;
    const float* ks = nullptr;
    const float* vs = nullptr;
    if constexpr (kInt8) {
      float* scale_f = reinterpret_cast<float*>(sm + L::kScaleF);
      if (ring) {
        const uint32_t* words =
            reinterpret_cast<const uint32_t*>(sm + L::kWords) + stage * 128;
        const uint8_t* sel = sm + L::kSel + stage * 128;
        if (tid < 64 || sweep2) {
          const uint32_t word = words[tid];
          const uint16_t half = sel[tid] ? static_cast<uint16_t>(word >> 16)
                                         : static_cast<uint16_t>(word & 0xFFFF);
          scale_f[tid] = __bfloat162float(__ushort_as_bfloat16(half));
        }
        widen_in_place<D>(sm + L::kK + stage * L::kTile,
                          sweep2 ? sm + L::kV + stage * L::kTile : nullptr);
      } else {
        scale_f[tid] = 1.f;          // fresh keys: ks = vs = 1, exact
      }
      fence_async_smem();
      __syncthreads();
      ks = scale_f;
      vs = scale_f + 64;
    }

    qk<D>(s, base + L::kQ, k_tile);
    // fp32 scores: the scale after the dot (int8: the key's scale first),
    // the cap (kCap), then the mask where the tile crosses an edge for
    // some live row
    bool masked;
    if (ring) {
      const int a0 = (r0 + i) * ppt;        // the tile's first page
      masked = kt < kSlots || a0 < rg.a_lo || a0 + ppt > rg.a_hi
               || a0 * ps <= q_last - window;
    } else {
      const int f = (f0 + i - n_r) * kSlots;
      masked = f + kSlots - 1 > t_first || f + kSlots > nl
               || st + f <= q_last - window;
    }
    const int* kp = kpos + stage * kSlots;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      float x = s[j];
      if constexpr (kInt8) x = x * ks[col];
      x = x * scale;
      if constexpr (kCap) x = softcap * tanhf(x / softcap);
      if (masked) {
        const int e = (j >> 1) & 1, pos = kp[col];
        if (!(pos <= q_abs[e] && pos > q_lo[e])) x = kMaskValue;
      }
      s[j] = x;
    }

    if (!sweep2) {
      // sweep 1: the row max, and l rescaled to it
      row_max_sum<true>(s, m, l);
    } else {
      // sweep 2: p at the true max, then PV on the tensor cores
      uint32_t a[4][4];
      uint32_t a2[4][4];
      probs<kInt8>(s, m, l, vs, lane, a, a2);
      pv<D>(o, a, v_tile);
      if constexpr (kInt8) pv<D>(o, a2, v_tile);
    }
    __syncthreads();     // the stage is refilled by the next step's copies
  }

  // one bf16 cast; rows past n_live are zeros, rows past T not written
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = tile * kRows + 16 * warp + (lane >> 2) + 8 * e;
    const int t = row / G;
    if (t >= T) continue;
    const bool live = t < nl;
    __nv_bfloat16* dst =
        out + (((size_t)b * T + t) * H + kh * G + row % G) * D;
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int d = 64 * h + 8 * c + 2 * (lane & 3);
        if (d < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(
              live ? o[h][4 * c + 2 * e] : 0.f,
              live ? o[h][4 * c + 2 * e + 1] : 0.f);
      }
  }
}

template <int D, bool kInt8, bool kCap>
int launch(const dim3& grid, cudaStream_t st, const __nv_bfloat16* q,
           const __nv_bfloat16* k_new, const __nv_bfloat16* v_new,
           const void* k_pages, const void* v_pages,
           const __nv_bfloat16* k_scale, const __nv_bfloat16* v_scale,
           const int32_t* tables, const int32_t* start,
           const int32_t* n_live, __nv_bfloat16* out, int T, int H, int K,
           int ps, int n_ring, int window, float scale, float softcap) {
  return launch_kernel<windowed_prefill_kernel<D, kInt8, kCap>>(
      grid, WLayout<D, kInt8>::kBytes + 1024, st, q, k_new, v_new, k_pages,
      v_pages, k_scale, v_scale, tables, start, n_live, out, T, H, K, ps,
      n_ring, window, scale, softcap);
}

}  // namespace

// q/out [B, T, H, D] bf16; k_new/v_new [B, T, K, D] bf16 (the chunk's
// fresh roped K/V); k_pages/v_pages [P, ps, K, D] bf16, or int8 with
// k_scale/v_scale [P, ps, K] bf16 (both null for bf16 pages), the
// pre-write pool; tables [B, n_ring], start [B] and n_live [B] int32;
// window > 0; softcap 0 (none) or the logit cap c > 0.  Returns 0 on success, else the cudaError_t of the refused
// or failed launch.
extern "C" int windowed_ragged_prefill(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* tables, const void* start, const void* n_live, void* out,
    int B, int T, int H, int K, int D, int ps, int n_ring, int window,
    float scale, float softcap, void* stream) {
  if (B < 1 || T < 1 || K < 1 || H % K != 0 || H / K > kMaxG || ps < 1 ||
      ps > kMaxPs || n_ring < 1 || window < 1 || !(softcap >= 0.f) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const dim3 grid((T * G + kRows - 1) / kRows, K, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* knp = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vnp = static_cast<const __nv_bfloat16*>(v_new);
  const auto* ksp = static_cast<const __nv_bfloat16*>(k_scale);
  const auto* vsp = static_cast<const __nv_bfloat16*>(v_scale);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* sp = static_cast<const int32_t*>(start);
  const auto* np = static_cast<const int32_t*>(n_live);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define WINDOWED_LAUNCH(DIM, INT8)                                          \
  return (softcap > 0.f ? launch<DIM, INT8, true>                           \
                        : launch<DIM, INT8, false>)(                        \
      grid, st, qp, knp, vnp, k_pages, v_pages, ksp, vsp, tp, sp, np, op, T, \
      H, K, ps, n_ring, window, scale, softcap)
  const bool int8 = k_scale != nullptr;
  if (D == 32 && !int8) WINDOWED_LAUNCH(32, false);
  if (D == 32) WINDOWED_LAUNCH(32, true);
  if (D == 64 && !int8) WINDOWED_LAUNCH(64, false);
  if (D == 64) WINDOWED_LAUNCH(64, true);
  if (D == 128 && !int8) WINDOWED_LAUNCH(128, false);
  if (D == 128) WINDOWED_LAUNCH(128, true);
#undef WINDOWED_LAUNCH
  return (int)cudaErrorInvalidValue;
}
