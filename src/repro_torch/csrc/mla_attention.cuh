// Absorbed-latent MLA paged attention for Hopper (sm_90a): Q query tokens
// per request (Q = 1 for decode, Q = 1 + draft length for speculative
// verify), every head of a token attending the request's latent pages
// through the page table: scores q_eff . ckv + q_rope . krope (times the
// scale), a softmax over the pages, and the context accumulated in latent
// space (acc += p * ckv), cast to bf16 once at the end.  The caller
// up-projects the context with w_uv.  bf16 latent pages, or int8 latent
// pages with one bf16 scale per token slot for ckv and one for krope.  One
// body, two entry points: mla_paged_decode.cu (kernel K5, Q = 1) and
// mla_paged_verify.cu (kernel K7).
//
// Replaces the Pallas TPU kernels repro/kernels/paged_attention/kernel.py::
// mla_paged_decode_fwd (_mla_paged_decode_kernel) and mla_paged_verify_fwd
// (_mla_paged_verify_kernel), bf16 or int8 latent pages.  Contract:
// repro/kernels/README.md "Inputs (decode cores)" and "Page-table layout":
// page 0 is the null page, which may be read but is masked like any slot;
// query j of row b sits at absolute position qp = pos[b] + j and sees slot
// idx iff idx <= qp and j < n_q[b] (kernel.py:_page_mask, window 0); rows
// with j >= n_q[b] finish as exact zeros.  int8 pages are dequantized per
// token slot as f32(q) * f32(s) (kernel.py:315-320), and that value feeds
// both the scores and the latent accumulator.
//
// What bounds it: all H heads share one latent "KV head", so a call reads
// every live token's latent once, (pos + n_q) * (L + R) * 2 bytes a
// request in bf16 (1152 bytes a token at deepseek-v2's L = 512, R = 64;
// int8: 576 + 4), and does 2 * H * (2 L + R) flops a token and query on
// it: about 240 flops a byte at H = 128 and one query, near the ~295 flops
// a byte at which the H100's bf16 tensor cores, not its memory, become the
// limit (989 TFLOP/s over 3.35 TB/s, NVIDIA's data sheet), and Q times
// that for the verify.  So the products belong on the tensor cores, and
// every staged key has to serve many heads.  Keeping p fp32 in value on
// bf16 tensor cores doubles PV's products (below): 2 (L + R) + 4 L flops a
// (query, key, head), the "two-term bound".
//
// Design.  The TPU grid (B, n_pages) carries a [Q * H, L] fp32
// accumulator in VMEM from page to page (256 KB per request and query at H
// = 128); Hopper blocks run in parallel and in no order, so a row's keys
// are split over blocks at absolute pages, and a second kernel merges:
//   * a row is a (query token, head) pair, token-major, and a block owns
//     one 64-row tile of them -- the `wgmma` M.  At deepseek-v2's H = 128
//     a tile is 64 heads of one token, all of them sharing every staged
//     key; at H = 8 or 16 the rows of several tokens fill a tile.  Rows
//     past Q * H are zeros in Q and never written;
//   * a split is kSplitPages = 8 absolute pages (split s holds pages 8 s ..
//     8 s + 7), never chosen from B, the row's length or the table's
//     width; the grid is (split, row tile, request), ceil(n_pages / 8)
//     splits.  A block sweeps its split's pages up to a_hi, the last page
//     its tile's last live query sees; a block whose split holds none of
//     them writes an empty partial (m = -inf) and exits;
//   * within a split, key tiles of 64 slots are four whole pages, each
//     page padded to 16 slots (ps <= 16), anchored at the split's first
//     page.  Q (64 x 576 bf16) is staged once; key tiles (ckv ++ krope, 64
//     x 576) by 16-byte cp.async copies, two stages deep, so the next
//     tile's copies land while this tile's products run; bf16 rows land in
//     128-byte-swizzled 64-column blocks (nine a row), the layout `wgmma`
//     reads without bank conflicts.  int8 tiles land raw, two stages deep,
//     and are widened into one bf16 tile in shared memory (exact: |q| <=
//     127 fits bf16's 8 significant bits), their scales beside them as
//     fp32.  Shared memory: Q 72 KB, 2 x 72 KB of key tiles, h1's 8 KB
//     tile and the rows' alphas: 225 KB a block (int8: Q, the bf16 tile,
//     two raw stages of 36 KB, h1 in the raw stage just widened, 1.75 KB
//     of scales), so one block an SM;
//   * the O accumulator is [64 x 512] fp32: 256 registers a thread for one
//     warpgroup, above the 255 a thread may hold.  So a block is two
//     warpgroups, each owning 256 of the latent columns (128 accumulator
//     registers a thread).  Warpgroup 0 computes the tile's S, the mask,
//     the online step and p, and hands p and each row's alpha to
//     warpgroup 1 through shared memory (one named barrier a tile); both
//     then run PV on their columns.  On the card this was 3-4 % faster
//     than each warpgroup computing the same S itself (PERF.md, K5/K7);
//   * QK^T is `wgmma.m64n64k16` (bf16 in, fp32 out) with Q and the key
//     tile from shared memory, over the 576 columns (bf16) or apart over
//     the 512 ckv and the 64 krope columns (int8: s = (cs * (q_eff . c8) +
//     rs * (q_rope . r8)), each part with its own scale), then times the
//     scale, then the mask (idx <= qp, live query, slot < ps);
//   * one online-softmax step a tile, with the guards of
//     _online_softmax_update (kernel.py:53): m_new = max(m, tile max), p =
//     exp(s - m_new) (0 while m_new is -inf), alpha = exp(m - m_new) (0
//     while m is -inf), l = l * alpha + sum p, O *= alpha;
//   * PV: V is the ckv part of the staged key tile, read MN-major.  p' = p
//     (int8: p * cs, the ckv scale folded in) is split into two bf16 terms
//     h1 = bf16(p') and h2 = bf16(p' - h1), stored as 64 x 64 K-major
//     tiles (h2 in the key tile's krope block, which QK^T no longer
//     needs), each the A operand of `wgmma.m64n64k16` from shared memory,
//     h1's four k16 steps before h2's, into the fp32 accumulator: each
//     product of a term and a bf16 (or int8-as-bf16) value is exact, so PV
//     sums p's 16 significant bits (|p' - h1 - h2| <= 2^-17 p'), far below
//     an output's bf16 ulp;
//   * the block writes each row's unnormalised partial (m, l and 512 fp32
//     accumulators) to a workspace the wrapper allocates, and a second
//     kernel merges a row's partials in increasing split order with the
//     guarded rescale (m = max, f = exp(m_s - m), l = l f_old + l_s f_s,
//     acc the same), skipping empty partials, and casts once after acc /
//     max(l, 1e-20) (kernel.py:70-72).  A row's non-empty splits are 0 ..
//     (qp / ps) / 8, so the merge reads no more than those.
//
// Why the bit-equalities hold.  A row's result is a function of its own
// query, its position and its pages: every score is one tensor-core dot of
// its own row and key; the softmax runs over the split's tiles in order,
// each thread's 16 columns in order, then a fixed shuffle tree over the
// row's 4 threads; a tile in which a row sees no key leaves its m, l and O
// unchanged bit for bit (m_new = m, alpha = 1, p = 0); splits follow
// absolute pages, and the merge runs over them in order.  Nothing depends
// on the other rows of the tile, how many tiles the block sweeps, or where
// the row sits in the tile.  So K7 at one live query reproduces K5 bit for
// bit, verify row j equals the decode row at pos + j, and a request alone
// equals its rows in the batch.
//
// The tensor-core machinery (copies, descriptors, swizzle, `wgmma` calls)
// and the online step are K2's and K9's, in ragged_prefill.cuh.
//
// Numerics: IEEE expf and division (build without --use_fast_math); fp32
// scores, scaled after the dot as in the reference; against the plain
// single-softmax version the split, the online softmax and the two-term p
// round at other points, so outputs agree to an output ulp.

#pragma once

#include "ragged_prefill.cuh"

// Internal linkage: K5 and K7 are separate libraries instantiating the same
// templates, and a template's static local (launch_split's opt-in flag)
// would otherwise be one object for the whole process (a GNU unique
// symbol), so the second library would skip its own shared-memory opt-in.
namespace mla {
namespace {

constexpr int kL = 512, kR = 64, kE = kL + kR;   // latent, rope, key width
constexpr int kBlockThreads = 2 * kThreads;     // two warpgroups
constexpr int kPageSlots = 16;                  // a page's slots in a tile
constexpr int kTilePages = kSlots / kPageSlots; // 4 pages a 64-slot tile
constexpr int kSplitPages = 8;                  // absolute pages a split
constexpr int kChunks = kE / 8;                 // 16-byte bf16 chunks a row
constexpr int kRawRow = kE;                     // bytes of a raw int8 row
constexpr int kTileBytes = kChunks / 8 * kHalf; // [64][576] bf16, swizzled
static_assert(kSplitPages % kTilePages == 0, "a split is whole key tiles");

// Shared-memory layout, in bytes from a 1024-aligned base.  bf16: Q, then
// two stages of the key tile, then the tile of p's first bf16 term h1.
// int8: Q, one bf16 key tile (widened from a raw stage), two raw stages
// [64][576] (h1's tile goes in the stage just widened), two stages of
// scale words ([ckv, krope][64] u32: the aligned 32-bit word holding a
// slot's bf16 scale) and which half of the word it is, and the widened
// tile's scales as fp32.  Both: each row's alpha of the tile.  The second
// term h2 goes in the key tile's krope block, which QK^T no longer needs.
template <bool kInt8>
struct Layout {
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;             // bf16: + stage * tile
  static constexpr int kRaw = 2 * kTileBytes;       // + stage * 64 * 576
  static constexpr int kWords = kRaw + 2 * kSlots * kRawRow;
  static constexpr int kSel = kWords + 2 * 2 * kSlots * 4;
  static constexpr int kScaleF = kSel + 2 * 2 * kSlots;   // [cs, rs][64]
  static constexpr int kP = 3 * kTileBytes;         // bf16: h1's tile
  static constexpr int kAlpha = kInt8 ? kScaleF + 2 * kSlots * 4
                                      : kP + kHalf;  // [64] f32
  static constexpr int kBytes = kAlpha + kSlots * 4;
};

// The absolute page a_hi up to which a tile of rows r0 .. r0 + rows - 1
// (token-major, H a token) sees keys: the last live query's page, at most
// the table's last; -1 when no row of the tile is live.
__device__ __forceinline__ int tile_last_page(int r0, int rows, int H,
                                              int p_b, int nq_b, int ps,
                                              int n_pages) {
  const int j_last = min((r0 + rows - 1) / H, nq_b - 1);
  const int last = p_b + j_last;
  if (j_last < r0 / H || last < 0) return -1;
  return min(last / ps, n_pages - 1);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// The two warpgroups meet here once a tile (barrier 1; __syncthreads is 0).
__device__ __forceinline__ void named_barrier_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kBlockThreads) : "memory");
}

// QK^T over the 576 key columns: 36 k16 steps into one accumulator.
// int8: the 512 ckv columns into ``s`` and the 64 krope columns into
// ``s_r``, one commit group.
template <bool kInt8>
__device__ __forceinline__ void qk_latent(float (&s)[32], float (&s_r)[32],
                                          uint32_t q, uint32_t k) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kE / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kHalf + (kk & 3) * 32;
    const uint64_t a = desc(q + off, 16, 1024), b = desc(k + off, 16, 1024);
    if (!kInt8 || kk < kL / 16)
      wgmma_ss(s, a, b, kk > 0);
    else
      wgmma_ss(s_r, a, b, kk > kL / 16);
  }
  wg_commit_wait();
  pin(s);
  if constexpr (kInt8) pin(s_r);
}

template <bool kInt8>
__global__ void __launch_bounds__(kBlockThreads, 1)
mla_split_kernel(const __nv_bfloat16* __restrict__ q_eff,  // [B, Q, H, L]
                 const __nv_bfloat16* __restrict__ q_rope, // [B, Q, H, R]
                 const void* __restrict__ ckv_v,           // [P, ps, L]
                 const void* __restrict__ krope_v,         // [P, ps, R]
                 const __nv_bfloat16* __restrict__ ckv_scale,    // [P, ps]
                 const __nv_bfloat16* __restrict__ krope_scale,  // [P, ps]
                 const int32_t* __restrict__ tables,       // [B, n_pages]
                 const int32_t* __restrict__ pos,          // [B]
                 const int32_t* __restrict__ n_q,          // [B] or null
                 float2* __restrict__ ws_ml,    // [B, n_splits, Q H]
                 float* __restrict__ ws_acc,    // [B, n_splits, Q H, L]
                 int Q, int H, int ps, int n_pages, int n_splits,
                 float scale) {
  using Lay = Layout<kInt8>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);

  const int split = blockIdx.x, tile = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / kThreads;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int QH = Q * H, r0 = tile * kRows, rows = min(kRows, QH - r0);
  const int p_b = pos[b], nq_b = n_q != nullptr ? n_q[b] : 1;
  const int a_hi = tile_last_page(r0, rows, H, p_b, nq_b, ps, n_pages);
  const int first = split * kSplitPages;
  const int final_ = min(a_hi, first + kSplitPages - 1);
  const size_t part = ((size_t)b * n_splits + split) * QH + r0;
  if (first > final_) {                          // no page of ours here
    for (int r = tid; r < rows; r += kBlockThreads)
      ws_ml[part + r] = make_float2(-INFINITY, 0.f);
    return;
  }
  const int n = (final_ - first) / kTilePages + 1;     // key tiles
  const int n_keys = n_pages * ps;
  const int32_t* tb = tables + (size_t)b * n_pages;

  // this thread's two accumulator rows' positions (-1: dead or padding)
  int qp[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * warp + (lane >> 2) + 8 * e, j = (r0 + r) / H;
    qp[e] = r < rows && j < nq_b ? p_b + j : -1;
  }

  // the block's 64 query rows (zeros past Q H) into the swizzled Q tile
  for (int e = tid; e < kRows * kChunks; e += kBlockThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r < rows;
    const size_t row = (size_t)b * QH + r0 + (ok ? r : 0);
    const __nv_bfloat16* src = c < kL / 8
        ? q_eff + row * kL + c * 8 : q_rope + row * kR + (c - kL / 8) * 8;
    cp_async16(base + Lay::kQ + swz(r, c), src, ok ? 16 : 0);
  }

  // key tile i of the split into stage ``stage``: slot r is token r % 16
  // of page first + 4 i + r / 16, zeros past ps or past final_
  auto issue = [&](int i, int stage) {
    if constexpr (kInt8) {
      constexpr int kC = kRawRow / 16;                 // 32 ckv + 4 krope
      const auto* ckv = static_cast<const int8_t*>(ckv_v);
      const auto* krope = static_cast<const int8_t*>(krope_v);
      const uint32_t dst = base + Lay::kRaw + stage * kSlots * kRawRow;
      for (int e = tid; e < kSlots * kC; e += kBlockThreads) {
        const int r = e / kC, c = e % kC;
        const int a = first + i * kTilePages + r / kPageSlots;
        const int t = r % kPageSlots;
        const bool ok = t < ps && a <= final_;
        const size_t slot = (size_t)(ok ? __ldg(tb + a) : 0) * ps
                            + (ok ? t : 0);
        const int8_t* src = c < kL / 16
            ? ckv + slot * kL + c * 16 : krope + slot * kR + (c - kL / 16) * 16;
        cp_async16(dst + r * kRawRow + c * 16, src, ok ? 16 : 0);
      }
      if (tid < 2 * kSlots) {            // the slot's ckv or krope scale
        const int r = tid % kSlots, which = tid / kSlots;
        const int a = first + i * kTilePages + r / kPageSlots;
        const int t = r % kPageSlots;
        const bool ok = t < ps && a <= final_;
        const size_t at = (size_t)(ok ? __ldg(tb + a) : 0) * ps
                          + (ok ? t : 0);
        const auto* words = reinterpret_cast<const uint32_t*>(
            which == 0 ? ckv_scale : krope_scale);
        const int w = (stage * 2 + which) * kSlots + r;
        cp_async4(base + Lay::kWords + w * 4, words + at / 2, ok ? 4 : 0);
        sm[Lay::kSel + w] = static_cast<uint8_t>(at & 1);
      }
    } else {
      const auto* ckv = static_cast<const __nv_bfloat16*>(ckv_v);
      const auto* krope = static_cast<const __nv_bfloat16*>(krope_v);
      const uint32_t dst = base + Lay::kK + stage * kTileBytes;
      for (int e = tid; e < kSlots * kChunks; e += kBlockThreads) {
        const int r = e / kChunks, c = e % kChunks;
        const int a = first + i * kTilePages + r / kPageSlots;
        const int t = r % kPageSlots;
        const bool ok = t < ps && a <= final_;
        const size_t slot = (size_t)(ok ? __ldg(tb + a) : 0) * ps
                            + (ok ? t : 0);
        const __nv_bfloat16* src = c < kL / 8
            ? ckv + slot * kL + c * 8 : krope + slot * kR + (c - kL / 8) * 8;
        cp_async16(dst + swz(r, c), src, ok ? 16 : 0);
      }
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[4][32];                      // this warpgroup's 256 columns
#pragma unroll
  for (int h = 0; h < 4; ++h)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[h][j] = 0.f;
  float s[32], s_r[32];

  issue(0, 0);
  cp_async_commit();                   // Q and tile 0
  for (int i = 0; i < n; ++i) {
    cp_async_wait_all();               // tile i (and Q) landed
    if constexpr (!kInt8) fence_async_smem();
    __syncthreads();                   // ... for every thread; and every
                                       // thread is done with tile i - 1
    if (i + 1 < n) issue(i + 1, (i + 1) & 1);    // lands during this tile
    cp_async_commit();

    uint32_t kt = base + Lay::kK + (i & 1) * kTileBytes;
    const float* cs = nullptr;
    const float* rs = nullptr;
    if constexpr (kInt8) {
      // widen raw stage i % 2 into the bf16 tile, its scales into fp32
      const int8_t* raw = reinterpret_cast<const int8_t*>(
          sm + Lay::kRaw + (i & 1) * kSlots * kRawRow);
      for (int e = tid; e < kSlots * (kRawRow / 16); e += kBlockThreads) {
        const int r = e / (kRawRow / 16), c = e % (kRawRow / 16);
        const int4 x = *reinterpret_cast<const int4*>(raw + r * kRawRow
                                                      + c * 16);
        const int8_t* v = reinterpret_cast<const int8_t*>(&x);
        uint32_t w[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          w[k] = pack_bf16(static_cast<float>(v[2 * k]),
                           static_cast<float>(v[2 * k + 1]));
        *reinterpret_cast<uint4*>(sm + Lay::kK + swz(r, 2 * c)) =
            make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(sm + Lay::kK + swz(r, 2 * c + 1)) =
            make_uint4(w[4], w[5], w[6], w[7]);
      }
      float* scale_f = reinterpret_cast<float*>(sm + Lay::kScaleF);
      if (tid < 2 * kSlots) {
        const int w = (i & 1) * 2 * kSlots + tid;
        const uint32_t word =
            reinterpret_cast<const uint32_t*>(sm + Lay::kWords)[w];
        const uint16_t half = sm[Lay::kSel + w]
            ? static_cast<uint16_t>(word >> 16)
            : static_cast<uint16_t>(word & 0xFFFF);
        scale_f[tid] = __bfloat162float(__ushort_as_bfloat16(half));
      }
      fence_async_smem();
      __syncthreads();
      kt = base + Lay::kK;
      cs = scale_f;
      rs = scale_f + kSlots;
    }

    // warpgroup 0: S, the mask, the online step (its own O rescaled), p's
    // two bf16 terms and each row's alpha into shared memory
    const uint32_t h1 = kInt8 ? base + Lay::kRaw + (i & 1) * kSlots * kRawRow
                              : base + Lay::kP;
    const uint32_t h2 = kt + 8 * kHalf;
    float* alpha_s = reinterpret_cast<float*>(sm + Lay::kAlpha);
    if (wg == 0) {
      qk_latent<kInt8>(s, s_r, base + Lay::kQ, kt);
      // fp32 scores (int8: each part times its own scale), times the
      // scale, then the mask: slots past ps, past the row's position or
      // the table
      const int key0 = (first + i * kTilePages) * ps;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const int t = col % kPageSlots;
        const int key = key0 + (col / kPageSlots) * ps + t;
        float x = s[j];
        if constexpr (kInt8) x = cs[col] * x + rs[col] * s_r[j];
        x = x * scale;
        if (t >= ps || key > qp[(j >> 1) & 1] || key >= n_keys)
          x = -INFINITY;
        s[j] = x;
      }
      float alpha[2];
      online_step<4>(s, m, l, o, alpha);         // s now holds p
      if constexpr (kInt8) {                     // p' = p * cs
#pragma unroll
        for (int j = 0; j < 32; ++j)
          s[j] = s[j] * cs[8 * (j >> 2) + 2 * (lane & 3) + (j & 1)];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * warp + (lane >> 2) + 8 * e;
        if ((lane & 3) == 0) alpha_s[r] = alpha[e];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = 4 * c + 2 * e;
          const __nv_bfloat162 t1 = __floats2bfloat162_rn(s[j], s[j + 1]);
          const uint32_t off = swz(r, c) + 4 * (lane & 3);
          st_shared(h1 + off, *reinterpret_cast<const uint32_t*>(&t1));
          st_shared(h2 + off, pack_bf16(s[j] - __low2float(t1),
                                        s[j + 1] - __high2float(t1)));
        }
      }
      fence_async_smem();
    }
    named_barrier_sync();                        // h1, h2 and alpha written
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = alpha_s[16 * warp + (lane >> 2) + 8 * e];
#pragma unroll
        for (int h = 0; h < 4; ++h)
#pragma unroll
          for (int j = 0; j < 32; ++j)
            if (((j >> 1) & 1) == e) o[h][j] *= a;
      }
    }
    // O += h1 V + h2 V: this warpgroup's 256 columns of the tile's ckv
    // part (MN-major), h1's four k16 steps before h2's
    const uint32_t v = kt + 4 * wg * kHalf;
    wg_fence();
#pragma unroll
    for (int term = 0; term < 2; ++term)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          wgmma_ss_mn(o[h], desc((term ? h2 : h1) + kk * 32, 16, 1024),
                      desc(v + h * kHalf + kk * 2048, 1024, 1024));
    wg_commit_wait();
#pragma unroll
    for (int h = 0; h < 4; ++h) pin(o[h]);
  }

  // the rows' partials; rows past Q H are not written
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * warp + (lane >> 2) + 8 * e;
    if (r >= rows) continue;
    if (wg == 0 && (lane & 3) == 0)
      ws_ml[part + r] = make_float2(m[e], l[e]);
    float* dst = ws_acc + (part + r) * kL + 256 * wg + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<float2*>(dst + 64 * h + 8 * c) =
            make_float2(o[h][4 * c + 2 * e], o[h][4 * c + 2 * e + 1]);
  }
}

// Merge a row's split partials in increasing split order and write its
// output: one block a (request, row), four latent columns a thread.  A
// live row at position qp has non-empty partials in splits 0 .. (qp / ps)
// / 8 (a dead row none: its output is exact zeros); they are loaded
// kAhead at a time, then folded in order.
constexpr int kMergeThreads = kL / 4;

__global__ void __launch_bounds__(kMergeThreads)
mla_merge_kernel(const float2* __restrict__ ws_ml,
                 const float* __restrict__ ws_acc,
                 const int32_t* __restrict__ pos,
                 const int32_t* __restrict__ n_q,
                 __nv_bfloat16* __restrict__ out,   // [B, Q, H, L]
                 int Q, int H, int ps, int n_pages, int n_splits) {
  const int QH = Q * H;
  const int b = blockIdx.x / QH, r = blockIdx.x % QH, j = r / H;
  const int d = threadIdx.x * 4;
  const int nq_b = n_q != nullptr ? n_q[b] : 1;
  const int qp = pos[b] + j;
  const int n_live = j < nq_b && qp >= 0
      ? min(qp / ps, n_pages - 1) / kSplitPages + 1 : 0;
  constexpr int kAhead = 8;
  float m = -INFINITY, l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < n_live; s0 += kAhead) {
    float2 ml[kAhead];
    float4 x[kAhead];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      ml[c] = make_float2(-INFINITY, 0.f);
      x[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0 + c < n_live) {
        const size_t at = ((size_t)b * n_splits + s0 + c) * QH + r;
        ml[c] = ws_ml[at];
        x[c] = *reinterpret_cast<const float4*>(ws_acc + at * kL + d);
      }
    }
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      if (ml[c].x == -INFINITY) continue;        // empty: an exact no-op
      const float m_new = fmaxf(m, ml[c].x);
      const float f_old = isfinite(m) ? expf(m - m_new) : 0.f;
      const float f_s = expf(ml[c].x - m_new);
      l = fmaf(l, f_old, ml[c].y * f_s);
      a[0] = fmaf(a[0], f_old, x[c].x * f_s);
      a[1] = fmaf(a[1], f_old, x[c].y * f_s);
      a[2] = fmaf(a[2], f_old, x[c].z * f_s);
      a[3] = fmaf(a[3], f_old, x[c].w * f_s);
      m = m_new;
    }
  }
  const float den = fmaxf(l, 1e-20f);
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
      out + ((size_t)b * QH + r) * kL + d);
  dst[0] = __floats2bfloat162_rn(a[0] / den, a[1] / den);
  dst[1] = __floats2bfloat162_rn(a[2] / den, a[3] / den);
}

// Launch the split kernel with its dynamic shared memory (the opt-in above
// 48 KB is set once per instantiation and library).
template <bool kInt8>
int launch_split(dim3 grid, cudaStream_t st, const __nv_bfloat16* q_eff,
                 const __nv_bfloat16* q_rope, const void* ckv,
                 const void* krope, const __nv_bfloat16* ckv_scale,
                 const __nv_bfloat16* krope_scale, const int32_t* tables,
                 const int32_t* pos, const int32_t* n_q, float2* ws_ml,
                 float* ws_acc, int Q, int H, int ps, int n_pages,
                 int n_splits, float scale) {
  constexpr int kSmem = Layout<kInt8>::kBytes + 1024;    // + alignment
  static_assert(kSmem <= 232448, "shared memory above the H100's 227 KB");
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_split_kernel<kInt8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  mla_split_kernel<kInt8><<<grid, kBlockThreads, kSmem, st>>>(
      q_eff, q_rope, ckv, krope, ckv_scale, krope_scale, tables, pos, n_q,
      ws_ml, ws_acc, Q, H, ps, n_pages, n_splits, scale);
  return (int)cudaGetLastError();
}

// Splits of a table of n_pages pages: every group of kSplitPages absolute
// pages it can hold.
int n_splits_of(int n_pages) {
  return (n_pages + kSplitPages - 1) / kSplitPages;
}

// q_eff/out [B, Q, H, L] and q_rope [B, Q, H, R] bf16; ckv [P, ps, L] and
// krope [P, ps, R] latent pages, bf16 (both scales null) or int8 (ckv_scale
// and krope_scale [P, ps] bf16); tables [B, n_pages], pos [B] and n_q [B]
// int32 (n_q null: every token live); workspace: the split partials, at
// least B * n_splits * Q * H * (L + 2) * 4 bytes ((m, l) pairs first, then
// the accumulators).  L = 512, R = 64 (deepseek-v2), H a multiple of 8, ps
// <= 16.  Launches the split kernel, grid (split, row tile, request), then
// the merge.  Returns 0 on success, else the cudaError_t of the refused or
// failed launch.
inline int launch(const void* q_eff, const void* q_rope, const void* ckv,
                  const void* krope, const void* ckv_scale,
                  const void* krope_scale, const void* tables,
                  const void* pos, const void* n_q, void* out,
                  void* workspace, long long workspace_bytes, int B, int Q,
                  int H, int L, int R, int ps, int n_pages, float scale,
                  void* stream) {
  if (B < 1 || Q < 1 || H < 8 || H % 8 != 0 || ps < 1 ||
      ps > kPageSlots || n_pages < 1 || L != kL || R != kR ||
      (ckv_scale == nullptr) != (krope_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_splits = n_splits_of(n_pages);
  const long long n_part = (long long)B * n_splits * Q * H;
  const long long tiles = ((long long)Q * H + kRows - 1) / kRows;
  if (workspace == nullptr || workspace_bytes < n_part * (kL + 2) * 4 ||
      tiles > 65535 || B > 65535 || (long long)B * Q * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto* ws_ml = static_cast<float2*>(workspace);
  auto* ws_acc = reinterpret_cast<float*>(ws_ml + n_part);
  const dim3 grid(n_splits, (unsigned)tiles, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qe = static_cast<const __nv_bfloat16*>(q_eff);
  const auto* qr = static_cast<const __nv_bfloat16*>(q_rope);
  const auto* cs = static_cast<const __nv_bfloat16*>(ckv_scale);
  const auto* rs = static_cast<const __nv_bfloat16*>(krope_scale);
  const auto* tb = static_cast<const int32_t*>(tables);
  const auto* pp = static_cast<const int32_t*>(pos);
  const auto* nq = static_cast<const int32_t*>(n_q);
  const int rc = cs != nullptr
      ? launch_split<true>(grid, st, qe, qr, ckv, krope, cs, rs, tb, pp, nq,
                           ws_ml, ws_acc, Q, H, ps, n_pages, n_splits, scale)
      : launch_split<false>(grid, st, qe, qr, ckv, krope, cs, rs, tb, pp,
                            nq, ws_ml, ws_acc, Q, H, ps, n_pages, n_splits,
                            scale);
  if (rc != 0) return rc;
  mla_merge_kernel<<<(unsigned)(B * Q * H), kMergeThreads, 0, st>>>(
      ws_ml, ws_acc, pp, nq, static_cast<__nv_bfloat16*>(out), Q, H, ps,
      n_pages, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mla
