// Ragged paged prefill for Hopper (sm_90a): a batch of prompt chunks, row b
// holding T queries at absolute positions start[b] + t, each attending the
// row's *post-write* pages (radix-cache prefix, earlier chunks and the
// chunk itself) through the page table with the causal rule k_abs <= q_abs.
//
// Replaces the Pallas TPU kernel repro/kernels/ragged_prefill/kernel.py::
// ragged_prefill_fwd (_ragged_prefill_kernel), bf16 pages or int8 pages with
// bf16 per-token-per-head scales, with or without its logit softcap.
// Contract: repro/kernels/README.md "The
// ragged-prefill contract" and "Scale-operand layout".
//
// What bounds it: operations.  The work is 4 * pairs * H * D flops for the
// causal (query, key) pairs against (keys * K * D * 2 + 2 * T * H * D) * 2
// bytes: at a 256-token chunk over a few thousand keys that is far above
// the H100's 295 flops a byte, so the products belong on the tensor cores
// (989 TFLOP/s bf16 dense, NVIDIA's data sheet).  The TPU body banks a
// [q_blk * G, n_pages * ps] fp32 score matrix in VMEM (kernel.py:189), far
// above the 227 KB of shared memory a Hopper block holds; here the scores
// are recomputed instead (two sweeps, below), so the tensor cores do 1.5x
// the function's products.
//
// Design.  One warpgroup (128 threads) per (64-row query tile, KV head,
// request).  A row is a (token, group head) pair, token-major, so all G
// heads of a KV head share every K/V tile and a token's G rows may straddle
// two tiles (G <= 128).  Keys go in tiles of whole pages, kt = (64 / ps) *
// ps keys in a 64-slot tile (slots past kt are masked), anchored at
// absolute key 0; tiles wholly past the query tile's last query are
// skipped, and only tiles that reach past its first query (or hold padding
// slots or keys past the table) are masked, element by element.  K and V
// tiles are staged in shared memory in their own width by 16-byte cp.async
// copies, two stages deep, so the next tile's copies (the block reads its
// own page-table row) overlap this tile's products; bf16 rows land in
// 128-byte-swizzled 64-column halves (D = 128 is two halves; D = 32 fills
// half of one), the layout `wgmma` reads without bank conflicts.  int8
// tiles land raw and are widened to bf16 in shared memory (exact: |k8| <=
// 127 fits bf16's 8 significant bits) before the products, their bf16
// scales beside them.  QK^T is `wgmma.m64n64k16` (bf16 in, fp32 out) with
// Q and the K tile from shared memory; PV is `wgmma.m64n64k16` with p as A
// from registers (the score accumulator's own layout) and the V tile as an
// MN-major B from shared memory, into fp32 accumulators.
//
// The contract (kernel.py:30-36 and :66-72): fp32 scores with the scale
// applied after the dot; with softcap > 0 the logit cap s = softcap *
// tanhf(s / softcap) (kernel.py:112-113; IEEE tanhf, not tanh.approx.f32,
// whose ~2^-11 relative error near |s| = softcap would move p by more than
// a row ulp) before the mask, which replaces the capped score (capping a
// masked score would make its key live at -softcap), in the one score loop
// both sweeps run, so sweep 2's p is taken at the max sweep 1 saw (a
// template flag, so the uncapped instantiations keep their code and
// registers); one softmax at each row's *true* max, never an
// online softmax of the output; masked keys at -1e30; p = exp(s - m) / l,
// rounded to bf16 for bf16 pages, fp32 for int8 pages (kernel.py:156-161);
// PV accumulated in fp32; one bf16 cast at the output.  Two sweeps:
//   sweep 1: each tile's scores, the row max m and the normalizer l; only
//            l is rescaled online when m grows, l * exp(m_old - m_new) +
//            sum exp(s - m_new) (tiles fully masked for a row add exactly
//            0 and leave m, so a row's l does not depend on the tile count);
//   sweep 2: the scores again (the same instructions, so the same bits), p
//            at the true m and final l, and PV on the tensor cores.
// int8 pages: the score is (q . k8) * ks[key] * scale in fp32, where the
// reference takes q . (f32(k8) * f32(ks)) * scale: f32(k8) * f32(ks) is
// exact, so the two differ only in fp32 rounding.  p stays fp32; its V
// scale is folded in as p' = p * vs[key] (fp32), and p' is split into two
// bf16 terms h1 = bf16(p'), h2 = bf16(p' - h1): h1 + h2 carries 16
// significant bits of p' (|p' - h1 - h2| <= 2^-17 |p'|), and each term
// times the int8-as-bf16 V tile is one exact product into the same fp32
// accumulator.  Two terms, not three: the difference from the reference's
// fp32 p * f32(v) products is then at most 2^-17 of sum |p v|, far below
// the one-bf16-ulp row bound (2^-8 of the row's largest output), and a
// third term would add a third of the PV products.
//
// A row's result depends only on its own q, its keys and its position: the
// key tiles are anchored at 0, a row's sums run over its own tiles in key
// order (each thread's 16 columns in order, then a fixed shuffle tree over
// the 4 threads of the row), and the tensor cores' sum for one output
// element reads only its own row.  So it is the same, bit for bit, however
// the prompt was cut into chunks and wherever the row lands in a tile.
// Queries past T (the last tile's padding) are computed and not written.
//
// The machinery K2 shares with K4 (copies, descriptors, swizzle, wgmma
// calls, the two sweeps' row reductions, the launch) is in
// ragged_prefill.cuh; the pool's staging and the int8 widening into
// separate bf16 tiles are K2's own (K4 widens in place: its note says why).
//
// Numerics: IEEE expf and division (build without --use_fast_math).

#include "ragged_prefill.cuh"

namespace {

// Shared-memory layout of one instantiation, in bytes from a 1024-aligned
// base.  bf16: Q, then two stages of K and of V.  int8: Q, one bf16 K and
// one bf16 V tile (widened from the raw stage), two raw stages of K and of
// V, two stages of scale words (the aligned 32-bit word holding a token's
// bf16 scale) and which half of the word it is, and the tile's scales as
// fp32.
template <int D, bool kInt8>
struct Layout {
  static constexpr int kHalves = (D + 63) / 64;
  static constexpr int kTile = kHalves * kHalf;        // a [64][D] bf16 tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                     // + stage * kTile
  static constexpr int kV = kInt8 ? 2 * kTile : 3 * kTile;
  static constexpr int kRawK = 3 * kTile;              // + stage * 64 * D
  static constexpr int kRawV = kRawK + 2 * kSlots * D;
  static constexpr int kWords = kRawV + 2 * kSlots * D;   // [2][2][64] u32
  static constexpr int kSel = kWords + 2 * 2 * kSlots * 4;  // [2][2][64] u8
  static constexpr int kScaleF = kSel + 2 * 2 * kSlots;     // [2][64] f32
  static constexpr int kBytes = kInt8 ? kScaleF + 2 * kSlots * 4 : 5 * kTile;
};

// Copy key tile ``i`` (its kt = ppt * ps token rows, zeros past the table)
// of one pool into a stage: bf16 rows swizzled, int8 rows raw [64][D].
template <int D, bool kInt8>
__device__ __forceinline__ void issue_kv(uint32_t dst,
                                         const void* __restrict__ pages,
                                         const int32_t* __restrict__ tb,
                                         const KvSlots<D, kInt8>& sl, int i,
                                         int ppt, int ps, int K, int kh,
                                         int n_pages) {
  constexpr int kE = kInt8 ? 1 : 2, kC = D * kE / 16;
  const char* base = static_cast<const char*>(pages);
#pragma unroll
  for (int it = 0; it < KvSlots<D, kInt8>::kIt; ++it) {
    if (sl.page[it] < 0) continue;
    const int e = threadIdx.x + it * kThreads, r = e / kC, c = e % kC;
    const int pi = i * ppt + sl.page[it];
    const bool ok = pi < n_pages;
    const char* src =
        base + (((size_t)(ok ? __ldg(tb + pi) : 0) * ps + sl.tok[it]) * K
                + kh) * D * kE + c * 16;
    cp_async16(dst + (kInt8 ? r * D + c * 16 : swz(r, c)), src,
               ok ? 16 : 0);
  }
}

// Copy the aligned 32-bit word that holds the bf16 scale of tile ``i``'s
// slot (its page in the tile and token in the page given) into ``word``,
// and note which half of the word it is (cp.async copies 4 bytes at
// least; the word's other half lies inside the allocation, which PyTorch
// rounds up to 512 bytes, even past the pool's last scale).
__device__ __forceinline__ void issue_scale(uint32_t word, uint8_t* sel,
                                            const __nv_bfloat16* __restrict__ scales,
                                            const int32_t* __restrict__ tb,
                                            int i, int ppt, int page, int tok,
                                            int ps, int K, int kh,
                                            int n_pages) {
  const int pi = i * ppt + page;
  const bool ok = pi < n_pages;
  const size_t at = ((size_t)(ok ? __ldg(tb + pi) : 0) * ps + tok) * K + kh;
  cp_async4(word, reinterpret_cast<const uint32_t*>(scales) + at / 2,
            ok ? 4 : 0);
  *sel = static_cast<uint8_t>(at & 1);
}

// Widen a raw int8 stage into the swizzled bf16 tile (rows past kt as
// zeros) and its scale words into fp32 (thread r: slot r of ``first``'s
// pool).
template <int D>
__device__ __forceinline__ void widen(uint8_t* tile, const int8_t* raw,
                                      int kt, const uint32_t* words,
                                      const uint8_t* sel, float* scale_f,
                                      int first) {
  constexpr int kC = D / 16;
#pragma unroll
  for (int it = 0; it < kSlots * kC / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / kC, c = e % kC;
    int4 x = make_int4(0, 0, 0, 0);
    if (r < kt) x = *reinterpret_cast<const int4*>(raw + r * D + c * 16);
    const int8_t* v = reinterpret_cast<const int8_t*>(&x);
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = pack_bf16(static_cast<float>(v[2 * j]),
                       static_cast<float>(v[2 * j + 1]));
    *reinterpret_cast<uint4*>(tile + swz(r, 2 * c)) =
        make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(tile + swz(r, 2 * c + 1)) =
        make_uint4(w[4], w[5], w[6], w[7]);
  }
  const int r = threadIdx.x - first;
  if (r >= 0 && r < kSlots) {
    const uint32_t word = words[r];
    const uint16_t half = sel[r] ? static_cast<uint16_t>(word >> 16)
                                 : static_cast<uint16_t>(word & 0xFFFF);
    scale_f[r] = __bfloat162float(__ushort_as_bfloat16(half));
  }
}

template <int D, bool kInt8, bool kCap>
__global__ void __launch_bounds__(kThreads)
ragged_prefill_kernel(const __nv_bfloat16* __restrict__ q,        // [B, T, H, D]
                      const void* __restrict__ k_pages,           // [P, ps, K, D]
                      const void* __restrict__ v_pages,           // [P, ps, K, D]
                      const __nv_bfloat16* __restrict__ k_scale,  // [P, ps, K]
                      const __nv_bfloat16* __restrict__ v_scale,  // [P, ps, K]
                      const int32_t* __restrict__ tables,         // [B, n_pages]
                      const int32_t* __restrict__ start,          // [B]
                      __nv_bfloat16* __restrict__ out,            // [B, T, H, D]
                      int T, int H, int K, int ps, int n_pages,
                      float scale, float softcap) {
  using L = Layout<D, kInt8>;
  constexpr int kH = L::kHalves;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);

  // a request's later query tiles attend more keys: start them first
  const int tile = gridDim.x - 1 - blockIdx.x, kh = blockIdx.y,
            b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int st = start[b];
  const int32_t* tb = tables + (size_t)b * n_pages;
  const int ppt = kSlots / ps, kt = ppt * ps;
  const int row_last = min(tile * kRows + kRows, T * G) - 1;
  const int q_first = st + tile * kRows / G, q_last = st + row_last / G;
  const int n = min(q_last / kt + 1, (n_pages + ppt - 1) / ppt);
  const int n_keys = n_pages * ps;

  // this thread's two accumulator rows and their positions
  int q_abs[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    q_abs[e] = st + (tile * kRows + 16 * warp + (lane >> 2) + 8 * e) / G;

  // zeros everywhere first: slots past kt, D = 32's unused columns and the
  // int8 tiles' pad are never copied, and must not hold NaN bits for PV
  for (int e = tid; e < L::kBytes / 16; e += kThreads)
    reinterpret_cast<uint4*>(sm)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // steps 0 .. n-1 are sweep 1 (K only), n .. 2n-1 sweep 2 (K and V)
  const KvSlots<D, kInt8> slots(ps, kt);
  const int s_slot = tid & 63;            // the scale this thread copies
  const int s_page = s_slot < kt ? s_slot / ps : -1, s_tok = s_slot % ps;
  auto issue = [&](int step) {
    const int i = step < n ? step : step - n, stage = step & 1;
    const bool with_v = step >= n;
    if constexpr (kInt8) {
      uint32_t* words = reinterpret_cast<uint32_t*>(sm + L::kWords) + stage * 128;
      uint8_t* sel = sm + L::kSel + stage * 128;
      issue_kv<D, true>(base + L::kRawK + stage * kSlots * D, k_pages, tb,
                        slots, i, ppt, ps, K, kh, n_pages);
      if (tid < 64 && s_page >= 0)
        issue_scale(smem_addr(words + s_slot), sel + s_slot, k_scale, tb, i,
                    ppt, s_page, s_tok, ps, K, kh, n_pages);
      if (with_v) {
        issue_kv<D, true>(base + L::kRawV + stage * kSlots * D, v_pages, tb,
                          slots, i, ppt, ps, K, kh, n_pages);
        if (tid >= 64 && s_page >= 0)
          issue_scale(smem_addr(words + 64 + s_slot), sel + 64 + s_slot,
                      v_scale, tb, i, ppt, s_page, s_tok, ps, K, kh,
                      n_pages);
      }
    } else {
      issue_kv<D, false>(base + L::kK + stage * L::kTile, k_pages, tb, slots,
                         i, ppt, ps, K, kh, n_pages);
      if (with_v)
        issue_kv<D, false>(base + L::kV + stage * L::kTile, v_pages, tb,
                           slots, i, ppt, ps, K, kh, n_pages);
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
    const bool sweep2 = step >= n;
    if (step + 1 < 2 * n) issue(step + 1);
    cp_async_commit();
    cp_async_wait1();
    fence_async_smem();
    __syncthreads();

    uint32_t k_tile, v_tile;
    const float* ks = nullptr;
    const float* vs = nullptr;
    if constexpr (kInt8) {
      const uint32_t* words =
          reinterpret_cast<const uint32_t*>(sm + L::kWords) + stage * 128;
      const uint8_t* sel = sm + L::kSel + stage * 128;
      float* scale_f = reinterpret_cast<float*>(sm + L::kScaleF);
      widen<D>(sm + L::kK, reinterpret_cast<const int8_t*>(
                   sm + L::kRawK + stage * kSlots * D),
               kt, words, sel, scale_f, 0);
      if (sweep2)
        widen<D>(sm + L::kV, reinterpret_cast<const int8_t*>(
                     sm + L::kRawV + stage * kSlots * D),
                 kt, words + 64, sel + 64, scale_f + 64, 64);
      fence_async_smem();
      __syncthreads();
      k_tile = base + L::kK;
      v_tile = base + L::kV;
      ks = scale_f;
      vs = scale_f + 64;
    } else {
      k_tile = base + L::kK + stage * L::kTile;
      v_tile = base + L::kV + stage * L::kTile;
    }

    qk<D>(s, base + L::kQ, k_tile);
    // fp32 scores: the scale after the dot (int8: the key's scale first),
    // the cap (kCap), then the mask where the tile reaches past the first
    // query
    const bool masked = kt < kSlots || (i + 1) * kt - 1 > q_first
                        || (i + 1) * ppt > n_pages;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      float x = s[j];
      if constexpr (kInt8) x = x * ks[col];
      x = x * scale;
      if constexpr (kCap) x = softcap * tanhf(x / softcap);
      if (masked) {
        const int key = i * kt + col;
        if (col >= kt || key > q_abs[(j >> 1) & 1] || key >= n_keys)
          x = kMaskValue;
      }
      s[j] = x;
    }

    if (!sweep2) {
      // sweep 1: the row max, and l rescaled to it
      row_max_sum<false>(s, m, l);
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

  // one bf16 cast; rows past T are not written
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = tile * kRows + 16 * warp + (lane >> 2) + 8 * e;
    const int t = row / G;
    if (t >= T) continue;
    __nv_bfloat16* dst =
        out + (((size_t)b * T + t) * H + kh * G + row % G) * D;
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int d = 64 * h + 8 * c + 2 * (lane & 3);
        if (d < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(
              o[h][4 * c + 2 * e], o[h][4 * c + 2 * e + 1]);
      }
  }
}

template <int D, bool kInt8, bool kCap>
int launch(const dim3& grid, cudaStream_t st, const __nv_bfloat16* q,
           const void* k_pages, const void* v_pages,
           const __nv_bfloat16* k_scale, const __nv_bfloat16* v_scale,
           const int32_t* tables, const int32_t* start, __nv_bfloat16* out,
           int T, int H, int K, int ps, int n_pages, float scale,
           float softcap) {
  return launch_kernel<ragged_prefill_kernel<D, kInt8, kCap>>(
      grid, Layout<D, kInt8>::kBytes + 1024, st, q, k_pages, v_pages,
      k_scale, v_scale, tables, start, out, T, H, K, ps, n_pages, scale,
      softcap);
}

}  // namespace

// q/out [B, T, H, D] bf16; k_pages/v_pages [P, ps, K, D] bf16, or int8
// with k_scale/v_scale [P, ps, K] bf16 (both null for bf16 pages); tables
// [B, n_pages] and start [B] int32; softcap 0 (none) or the logit cap c >
// 0.  Returns 0 on success, else the cudaError_t of the refused or failed
// launch.
extern "C" int ragged_prefill(const void* q, const void* k_pages,
                              const void* v_pages, const void* k_scale,
                              const void* v_scale, const void* tables,
                              const void* start, void* out, int B, int T,
                              int H, int K, int D, int ps, int n_pages,
                              float scale, float softcap, void* stream) {
  if (B < 1 || T < 1 || K < 1 || H % K != 0 || H / K > kMaxG || ps < 1 ||
      ps > kMaxPs || n_pages < 1 || !(softcap >= 0.f) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const dim3 grid((T * G + kRows - 1) / kRows, K, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* ksp = static_cast<const __nv_bfloat16*>(k_scale);
  const auto* vsp = static_cast<const __nv_bfloat16*>(v_scale);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* sp = static_cast<const int32_t*>(start);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define PREFILL_LAUNCH(DIM, INT8)                                          \
  return (softcap > 0.f ? launch<DIM, INT8, true>                         \
                        : launch<DIM, INT8, false>)(                      \
      grid, st, qp, k_pages, v_pages, ksp, vsp, tp, sp, op, T, H, K, ps,  \
      n_pages, scale, softcap)
  const bool int8 = k_scale != nullptr;
  if (D == 32 && !int8) PREFILL_LAUNCH(32, false);
  if (D == 32) PREFILL_LAUNCH(32, true);
  if (D == 64 && !int8) PREFILL_LAUNCH(64, false);
  if (D == 64) PREFILL_LAUNCH(64, true);
  if (D == 128 && !int8) PREFILL_LAUNCH(128, false);
  if (D == 128) PREFILL_LAUNCH(128, true);
#undef PREFILL_LAUNCH
  return (int)cudaErrorInvalidValue;
}
