// Paged attention for Hopper (sm_90a): Q query tokens per request (Q = 1 for
// decode, Q = 1 + draft length for speculative verify), GQA, read straight
// out of the paged KV pool through the page table, bf16 pages or int8 pages
// with bf16 per-token-per-head scales, full causal attention or a
// sliding-window page ring.  One body, two entry points: paged_decode.cu
// (kernel K1, Q = 1, at most 16 rows a block) and paged_verify.cu (kernel
// K3, at most 48 rows a block).
//
// Replaces the Pallas TPU kernels repro/kernels/paged_attention/kernel.py::
// paged_decode_fwd (_paged_decode_kernel) and paged_verify_fwd
// (_paged_verify_kernel), window = 0 or > 0, softcap = 0 or > 0, bf16 or
// int8 pages.  Contract: repro/kernels/README.md "Inputs (decode cores)",
// "Page-table layout" and "Scale-operand layout" -- page 0 is the null
// page, which may be read but is masked like any slot; query j of row b
// sits at absolute position qp = pos[b] + j and, with window = 0, sees slot
// idx iff idx <= qp and j < n_q[b]; rows with j >= n_q[b] finish as exact
// zeros.  With window > 0 the table is a ring of ring = n_pages * ps token
// slots: slot qp % ring holds qp, so slot idx holds k_abs = qp - ((qp %
// ring - idx) mod ring), seen iff k_abs >= 0 and k_abs > qp - window
// (_page_mask, kernel.py:81-91).
//
// What bounds it: the bytes of K/V pages read.  One call reads every live
// token's K and V of every KV head, min(pos + n_q, ring) * K * D * 2 * 2
// bytes a request in bf16 (int8: 1 byte a value plus a 2-byte scale a token
// and head), and does 4 * rows * keys * D flops on them: at most 4 * 48 /
// 4 = 48 flops a byte at 48 rows, far below the ~295 flops a byte at which
// the H100's bf16 tensor cores, not its memory, become the limit (989
// TFLOP/s over 3.35 TB/s, NVIDIA's data sheet).  So the design is about
// keeping enough bytes in flight on every SM, not about the products.
//
// Design.  The TPU grid (B, K, n_pages) runs in order and carries (m, l,
// acc) in VMEM from page to page; Hopper blocks run in parallel and in no
// order, so a row's keys are split over blocks at a fixed split:
//   * a block owns (split, KV head x row block, request).  A split is
//     kSplitPages = 16 absolute pages (256 keys at 16-token pages), group
//     g holding absolute pages 16 g .. 16 g + 15.  The block sweeps the
//     absolute pages a_lo..a_hi of its rows (page a at table slot a, or a
//     mod n_pages in a ring): causal, pages 0 .. last / ps; ring, the
//     n_pages newest pages up to last / ps, where last is the position of
//     the block's last live query.  Grid x covers every split the table
//     can hold, ceil(n_pages / 16), plus one in a ring, whose n_pages pages
//     can straddle one more group; split x is group x (causal) or a_lo / 16
//     + x (ring).  The split is never chosen from B, the row's length or
//     the ring's length.  A block whose group holds none of a_lo..a_hi
//     writes an empty partial (m = -inf) and exits;
//   * rows are the block's (query token, group head) pairs, token-major,
//     in m16 tiles (K1 one, K3 up to three).  The block stages its split's
//     pages in shared memory by 16-byte cp.async, each page padded to 16
//     key slots, Q and K in one commit group and V in a second, so all of
//     the split's bytes are in flight at once and V lands while QK^T runs.
//     int8 pages land raw and are widened to bf16 in shared memory (exact:
//     |k8| <= 127 fits bf16's 8 significant bits); their scales as fp32;
//   * QK^T on the tensor cores: mma.sync.m16n8k16 bf16 -> fp32 over D / 16
//     k-steps, the K scale (int8) and then the scale applied to the fp32
//     dot (kernel.py:123-126), then, with softcap > 0, the logit cap s =
//     softcap * tanhf(s / softcap) (kernel.py:127-128; IEEE tanhf, not
//     tanh.approx.f32, whose ~2^-11 relative error near |s| = softcap
//     would move p by more than a row ulp), then the mask, which replaces
//     the capped score (capping a masked -inf would give -softcap, a live
//     key): S [rows, 256] fp32 in shared memory.  The cap is a template
//     flag (kCap), so the uncapped instantiations keep their code,
//     registers, bits and times (a runtime branch on softcap in one body
//     takes K3's registers from 62 to 75, spills at D = 128 and costs it
//     4-7 %);  A block is eight warps, two an SM sub-partition, so one
//     hides the other's latency; warp w scores pages 2 w and 2 w + 1;
//   * the split's softmax at once, per row: m = max over the 256 slots; p
//     = exp(s - m) with the guards of _online_softmax_update (kernel.py:
//     53-67): -inf masking, p = 0 and m = -inf where no slot is visible;
//     l = sum p, lane i summing slots i, i + 32, .. in order, then an xor
//     shuffle tree;
//   * p stays fp32 in value.  p' = p (int8: p * vs, the V scale folded in)
//     is split into two bf16 terms h1 = bf16(p'), h2 = bf16(p' - h1): h1 +
//     h2 carries 16 significant bits (|p' - h1 - h2| <= 2^-17 p'), and each
//     term times a bf16 (or int8-as-bf16) V value is an exact product.  PV
//     is mma.sync.m16n8k16 with one page as one k16 step, h1 then h2, in
//     increasing page order, warp w owning output columns w D / 8 .. (w +
//     1) D / 8 - 1 (D / 4 at D = 32, four warps).  Two terms, not three:
//     the difference from the reference's fp32 products is at most 2^-17
//     of sum |p v|, far below the one-bf16-ulp row bound (2^-8 of the
//     row's largest output);
//   * the block writes its unnormalised partial (m, l, acc) to the
//     workspace, and a second kernel merges a row's partials in increasing
//     absolute split order with the guarded rescale (m = max, f = exp(m_s -
//     m), l = l f_old + l_s f_s, acc the same) and casts to bf16 once,
//     after acc / max(l, 1e-20) (kernel.py:70-72).  Empty partials are
//     skipped, which is what merging them would do bit for bit.
// mma.sync, not wgmma: a decode block has at most 16 rows and a verify
// block 48, far below wgmma's 64, and the bytes, not the products, bound
// the kernel; m16 tiles let K1 and K3 issue the same instructions on a row.
//
// Why the bit-equalities hold.  A row's result is a function of its own q,
// its position, the keys it sees and the block's page range: every score
// is one mma dot product of its own row and key; the softmax and PV of a
// row run over the split's 256 slots with a fixed lane <-> slot map and
// fixed k-order; the merge runs over splits in order.  Nothing depends on
// how many rows a block holds or where the row sits in its m16 tile, so K3
// at one live query reproduces K1 bit for bit, a verify row j equals the
// decode row at pos + j, and a row alone equals the row in its batch.
// Splits follow absolute pages, so a ring of n_pages + 1 (the speculative
// pool's slack page) holding the same window adds only its oldest page,
// which no row sees: its scores are -inf, its p exactly 0 (a no-op on m, l
// and on every mma sum), and if it opens a group of its own that partial
// is empty.  So the ring's length changes no bit.
//
// Numerics: IEEE expf and division (build without --use_fast_math); fp32
// scores and sums; against the plain single-softmax version the split and
// the two-term p round at other points, so outputs agree to an output ulp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Internal linkage: K1 and K3 are separate libraries built from this one
// header, and a template's static local (launch_one's opt-in flag) would
// otherwise be one GNU-unique object for the whole process, so the second
// library would skip its own shared-memory opt-in.
namespace paged {
namespace {

constexpr int kThreads = 256;            // eight warps, two an SM sub-partition
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPs = 16;               // tokens per page: one k16 step
constexpr int kSplitPages = 16;          // absolute pages a split
constexpr int kWarpPages = kSplitPages / kWarps;   // pages a warp scores
constexpr int kSlots = kSplitPages * kMaxPs;   // key slots a split
constexpr int kPStride = kSlots + 8;     // bf16 a row of p (bank offset)
constexpr int kSStride = kSlots + 8;     // fp32 a row of scores

// Shared-memory layout of one instantiation, in bytes: Q; region A (the K
// tile, then the two p tiles); the V tile; the scores (int8: inside the V
// tile where they fit -- V is widened after the softmax); int8's raw K and
// V tiles and fp32 scales; the split's page ids and table slots; each
// row's query position (-1 for a dead row) and position mod ring.
template <int D, int kMaxRows, bool kInt8>
struct Layout {
  static constexpr int kMT = (kMaxRows + 15) / 16;       // m16 tiles
  static constexpr int kRowsPad = kMT * 16;
  static constexpr int kKv = D + 8;                      // bf16 a K/V/Q row
  static constexpr int kQ = 0;
  static constexpr int kQBytes = kRowsPad * kKv * 2;
  static constexpr int kTile = kSlots * kKv * 2;         // a bf16 K or V tile
  static constexpr int kPBytes = kRowsPad * kPStride * 2;    // one p term
  static constexpr int kABytes = kTile > 2 * kPBytes ? kTile : 2 * kPBytes;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kABytes;
  static constexpr int kSBytes = kRowsPad * kSStride * 4;
  static constexpr bool kSInV = kInt8 && kSBytes <= kTile;
  static constexpr int kS = kSInV ? kV : kV + kTile;
  static constexpr int kRawK = kSInV ? kV + kTile : kS + kSBytes;
  static constexpr int kRawV = kRawK + (kInt8 ? kSlots * D : 0);
  static constexpr int kScales = kRawV + (kInt8 ? kSlots * D : 0);
  static constexpr int kPages = kScales + (kInt8 ? 2 * kSlots * 4 : 0);
  static constexpr int kRowInfo = kPages + 2 * kSplitPages * 4;
  static constexpr int kBytes = kRowInfo + 2 * kRowsPad * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += A B, m16n8k16, bf16 in, fp32 accumulate: A row-major (4 registers
// of bf16 pairs), B column-major (2 registers).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Whether query position qp (qmod = qp % ring) sees slot idx of the row's
// logical view: the causal rule (window = 0) or the ring rule.  idx and
// qmod lie in [0, ring), so one conditional add is Python's modulo.
__device__ __forceinline__ bool visible(int idx, int qp, int qmod, int window,
                                        int ring) {
  if (window == 0) return idx <= qp;
  int back = qmod - idx;
  if (back < 0) back += ring;
  const int k_abs = qp - back;                   // k_abs <= qp by build
  return k_abs >= 0 && k_abs > qp - window;
}

// Widen the raw int8 rows of pages po_lo..po_hi into the bf16 tile.
template <int D>
__device__ __forceinline__ void widen(uint8_t* tile, const int8_t* raw,
                                      int po_lo, int po_hi) {
  constexpr int kC = D / 16;                     // 16 int8 values a chunk
  const int n = (po_hi - po_lo + 1) * kMaxPs * kC;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int slot = po_lo * kMaxPs + e / kC, c = e % kC;
    const int4 x = *reinterpret_cast<const int4*>(raw + slot * D + c * 16);
    const int8_t* v = reinterpret_cast<const int8_t*>(&x);
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(
          static_cast<float>(v[2 * j]), static_cast<float>(v[2 * j + 1]));
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    uint4* dst = reinterpret_cast<uint4*>(tile + (slot * (D + 8) + c * 16) * 2);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// Copy the K or V rows of pages po_lo..po_hi of the split (page ids in pg)
// into a tile: bf16 rows of D + 8 elements, or raw int8 rows of D bytes.
// Slots t >= ps of a page are zero-filled.
template <int D, bool kInt8>
__device__ __forceinline__ void issue_kv(uint32_t dst, const void* pages,
                                         const int* pg, int po_lo, int po_hi,
                                         int ps, int K, int kh) {
  constexpr int kE = kInt8 ? 1 : 2;              // bytes a value
  constexpr int kC = D * kE / 16;                // 16-byte chunks a row
  constexpr int kRow = kInt8 ? D : (D + 8) * 2;  // bytes a tile row
  const char* base = static_cast<const char*>(pages);
  const int n = (po_hi - po_lo + 1) * kMaxPs * kC;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int slot = po_lo * kMaxPs + e / kC, c = e % kC;
    const int t = slot % kMaxPs;
    const bool ok = t < ps;
    const char* src = base + (((size_t)pg[slot / kMaxPs] * ps + (ok ? t : 0))
                              * K + kh) * D * kE + c * 16;
    cp_async16(dst + slot * kRow + c * 16, src, ok ? 16 : 0);
  }
}

template <int D, int kMaxRows, bool kInt8, bool kCap>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,        // [B, Q, H, D]
                   const void* __restrict__ k_pages,           // [P, ps, K, D]
                   const void* __restrict__ v_pages,           // [P, ps, K, D]
                   const __nv_bfloat16* __restrict__ k_scale,  // [P, ps, K]
                   const __nv_bfloat16* __restrict__ v_scale,  // [P, ps, K]
                   const int32_t* __restrict__ tables,         // [B, n_pages]
                   const int32_t* __restrict__ pos,            // [B]
                   const int32_t* __restrict__ n_q,            // [B] or null
                   float2* __restrict__ ws_ml,     // [B K, n_splits, Q G]
                   float* __restrict__ ws_acc,     // [B K, n_splits, Q G, D]
                   int Q, int K, int G, int ps, int n_pages, int window,
                   int qpb, int n_splits, float scale, float softcap) {
  using L = Layout<D, kMaxRows, kInt8>;
  constexpr int kMT = L::kMT;
  constexpr int kPvWarps = D / 8 < kWarps ? D / 8 : kWarps;   // PV's warps
  constexpr int kNT = D / 8 / kPvWarps;   // output n8 tiles a PV warp owns
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);

  const int split = blockIdx.x;
  const int kh = blockIdx.y % K, rb = blockIdx.y / K, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = K * G, QG = Q * G;
  const int j0 = rb * qpb;                       // the block's first token
  const int rows = min(qpb, Q - j0) * G;
  const int ring = n_pages * ps;
  const int p_b = pos[b];
  const int nq_b = n_q ? n_q[b] : 1;
  // the block's last live query, its position, and the absolute pages the
  // rows can see, oldest first (page a at table slot a, or a % n_pages)
  const int j_last = min(j0 + rows / G, nq_b) - 1;
  const int last = p_b + j_last;
  int a_hi = (j_last < j0 || last < 0) ? -1 : last / ps;
  if (window == 0 && a_hi > n_pages - 1) a_hi = n_pages - 1;
  const int a_lo = max(0, a_hi - n_pages + 1);
  const int group = (window == 0 ? 0 : a_lo / kSplitPages) + split;
  const int first = max(a_lo, group * kSplitPages);
  const int final_ = min(a_hi, group * kSplitPages + kSplitPages - 1);
  const size_t part = ((size_t)(b * K + kh) * n_splits + split) * QG
                      + (size_t)j0 * G;
  if (first > final_) {                          // no page of ours here
    for (int r = tid; r < rows; r += kThreads)
      ws_ml[part + r] = make_float2(-INFINITY, 0.f);
    return;
  }
  const int po_lo = first - group * kSplitPages;
  const int po_hi = final_ - group * kSplitPages;
  const int mt_n = (rows + 15) / 16;             // m16 tiles in use

  int* pg = reinterpret_cast<int*>(smem + L::kPages);   // page ids, slots
  int* row_qp = reinterpret_cast<int*>(smem + L::kRowInfo);
  int* row_qmod = row_qp + L::kRowsPad;
  if (tid < kSplitPages) {
    const int a = group * kSplitPages + tid;
    const int i = window == 0 ? a : a % n_pages;
    pg[tid] = (tid >= po_lo && tid <= po_hi)
                  ? tables[(size_t)b * n_pages + i] : 0;
    pg[kSplitPages + tid] = i;
  }
  for (int r = tid; r < mt_n * 16; r += kThreads) {
    const int j = j0 + r / G;
    const bool live = r < rows && j < nq_b;
    row_qp[r] = live ? p_b + j : -1;
    row_qmod[r] = window == 0 ? 0 : (p_b + j) % ring;
  }
  __syncthreads();

  // group 0: Q (rows past ``rows`` zero) and K; group 1: V
  {
    constexpr int kC = D / 8;
    for (int e = tid; e < mt_n * 16 * kC; e += kThreads) {
      const int r = e / kC, c = e % kC;
      const bool ok = r < rows;
      const int j = ok ? j0 + r / G : 0, g = ok ? r % G : 0;
      cp_async16(sbase + L::kQ + (r * L::kKv + c * 8) * 2,
                 q + (((size_t)b * Q + j) * H + kh * G + g) * D + c * 8,
                 ok ? 16 : 0);
    }
  }
  issue_kv<D, kInt8>(sbase + (kInt8 ? L::kRawK : L::kK), k_pages, pg, po_lo,
                     po_hi, ps, K, kh);
  cp_async_commit();
  issue_kv<D, kInt8>(sbase + (kInt8 ? L::kRawV : L::kV), v_pages, pg, po_lo,
                     po_hi, ps, K, kh);
  cp_async_commit();
  float* ks = reinterpret_cast<float*>(smem + L::kScales);
  float* vs = ks + kSlots;
  if constexpr (kInt8) {
    for (int slot = tid; slot < kSlots; slot += kThreads) {
      const int po = slot / kMaxPs, t = slot % kMaxPs;
      float a = 0.f, c = 0.f;
      if (po >= po_lo && po <= po_hi && t < ps) {
        const size_t at = ((size_t)pg[po] * ps + t) * K + kh;
        a = __bfloat162float(k_scale[at]);
        c = __bfloat162float(v_scale[at]);
      }
      ks[slot] = a;
      vs[slot] = c;
    }
  }

  cp_async_wait<1>();
  __syncthreads();
  if constexpr (kInt8) {
    widen<D>(smem + L::kK,
             reinterpret_cast<const int8_t*>(smem + L::kRawK), po_lo, po_hi);
    __syncthreads();
  }

  // QK^T: warp w scores pages 2 w and 2 w + 1 of the split for every row
  float* S = reinterpret_cast<float*>(smem + L::kS);
#pragma unroll 1
  for (int po = warp * kWarpPages; po < (warp + 1) * kWarpPages; ++po) {
    if (po < po_lo || po > po_hi) {
      for (int e = lane; e < mt_n * 16 * kMaxPs; e += 32)
        S[(e / kMaxPs) * kSStride + po * kMaxPs + e % kMaxPs] = -INFINITY;
      continue;
    }
    float acc[kMT][2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[mt][x / 4][x % 4] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bk[4];      // keys 0-7 / 8-15, dims 0-7 / 8-15 of this step
      ldsm_x4(sbase + L::kK
                  + ((po * kMaxPs + (lane / 16) * 8 + lane % 8) * L::kKv
                     + kk * 16 + ((lane / 8) % 2) * 8) * 2,
              bk);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt < mt_n) {
          uint32_t aq[4];
          ldsm_x4(sbase + L::kQ
                      + ((mt * 16 + lane % 16) * L::kKv + kk * 16
                         + (lane / 16) * 8) * 2,
                  aq);
          mma16816(acc[mt][0], aq, bk[0], bk[1]);
          mma16816(acc[mt][1], aq, bk[2], bk[3]);
        }
      }
    }
    const int i = pg[kSplitPages + po];          // the page's table slot
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt >= mt_n) continue;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int nt = x / 4, e = (x / 2) % 2, h = x % 2;
        const int t = nt * 8 + 2 * (lane % 4) + h;
        const int r = mt * 16 + lane / 4 + 8 * e;
        float s = acc[mt][nt][2 * e + h];
        if constexpr (kInt8) s = s * ks[po * kMaxPs + t];
        s = s * scale;
        if constexpr (kCap) s = softcap * tanhf(s / softcap);
        const int qp = row_qp[r];
        const bool ok = qp >= 0 && t < ps &&
                        visible(i * ps + t, qp, row_qmod[r], window, ring);
        S[r * kSStride + po * kMaxPs + t] = ok ? s : -INFINITY;
      }
    }
  }
  __syncthreads();

  // the split's softmax, a warp a row (two rows at once, r and r + 8, to
  // overlap their shuffle chains): m, p = exp(s - m) split into two bf16
  // terms (int8: p * vs), l = sum p; the p tiles overwrite K
  __nv_bfloat16* P1 = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  __nv_bfloat16* P2 = P1 + L::kRowsPad * kPStride;
  for (int r0 = warp; r0 < mt_n * 16; r0 += 2 * kWarps) {
    float s[2][kSlots / 32], mx[2], sum[2];
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      mx[y] = -INFINITY;
#pragma unroll
      for (int x = 0; x < kSlots / 32; ++x) {
        s[y][x] = S[(r0 + y * kWarps) * kSStride + lane + 32 * x];
        mx[y] = fmaxf(mx[y], s[y][x]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
#pragma unroll
      for (int y = 0; y < 2; ++y)
        mx[y] = fmaxf(mx[y], __shfl_xor_sync(0xffffffffu, mx[y], off));
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int r = r0 + y * kWarps;
      const bool fin = isfinite(mx[y]);
      const float safe = fin ? mx[y] : 0.f;
      sum[y] = 0.f;
#pragma unroll
      for (int x = 0; x < kSlots / 32; ++x) {
        const int slot = lane + 32 * x;
        const float p = fin ? expf(s[y][x] - safe) : 0.f;
        sum[y] += p;
        float pv = p;
        if constexpr (kInt8) pv = p * vs[slot];
        const __nv_bfloat16 h1 = __float2bfloat16_rn(pv);
        P1[r * kPStride + slot] = h1;
        P2[r * kPStride + slot] =
            __float2bfloat16_rn(pv - __bfloat162float(h1));
      }
      if (!fin) mx[y] = -INFINITY;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
#pragma unroll
      for (int y = 0; y < 2; ++y)
        sum[y] += __shfl_xor_sync(0xffffffffu, sum[y], off);
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int r = r0 + y * kWarps;
      if (lane == 0 && r < rows)
        ws_ml[part + r] = make_float2(mx[y], sum[y]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kInt8) {
    widen<D>(smem + L::kV,
             reinterpret_cast<const int8_t*>(smem + L::kRawV), po_lo, po_hi);
    __syncthreads();
  }

  // PV: one page a k16 step, h1 then h2, pages in order; warp w < kPvWarps
  // owns output columns w D / kPvWarps .. (w + 1) D / kPvWarps - 1
  if (warp >= kPvWarps) return;
  float o[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[mt][nt][x] = 0.f;
  const int col0 = warp * (D / kPvWarps);
#pragma unroll 1
  for (int po = po_lo; po <= po_hi; ++po) {
    uint32_t bv[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      ldsm_x2_t(sbase + L::kV
                    + ((po * kMaxPs + lane % 16) * L::kKv + col0 + nt * 8) * 2,
                bv[nt]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt >= mt_n) continue;
      uint32_t a1[4], a2[4];
      const uint32_t at = ((mt * 16 + lane % 16) * kPStride + po * kMaxPs
                           + (lane / 16) * 8) * 2;
      ldsm_x4(sbase + L::kK + at, a1);
      ldsm_x4(sbase + L::kK + L::kPBytes + at, a2);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        mma16816(o[mt][nt], a1, bv[nt][0], bv[nt][1]);
        mma16816(o[mt][nt], a2, bv[nt][0], bv[nt][1]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    if (mt >= mt_n) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = mt * 16 + lane / 4 + 8 * e;
      if (r >= rows) continue;
      float* dst = ws_acc + (part + r) * D + col0 + 2 * (lane % 4);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<float2*>(dst + nt * 8) =
            make_float2(o[mt][nt][2 * e], o[mt][nt][2 * e + 1]);
    }
  }
}

// Merge a row's split partials in increasing split order and write its
// output: one block a (request, KV head, row), one thread an output dim.
__global__ void paged_merge_kernel(const float2* __restrict__ ws_ml,
                                   const float* __restrict__ ws_acc,
                                   __nv_bfloat16* __restrict__ out,  // [B, Q, H, D]
                                   int Q, int K, int G, int D, int n_splits) {
  const int QG = Q * G;
  const int bk = blockIdx.x / QG, r = blockIdx.x % QG;
  const int b = bk / K, kh = bk % K, j = r / G, g = r % G;
  const int d = threadIdx.x;
  constexpr int kAhead = 8;              // partials loaded before use
  float m = -INFINITY, l = 0.f, a = 0.f;
  for (int s0 = 0; s0 < n_splits; s0 += kAhead) {
    float2 ml[kAhead];
    float x[kAhead];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      const size_t at =
          ((size_t)bk * n_splits + min(s0 + c, n_splits - 1)) * QG + r;
      ml[c] = s0 + c < n_splits ? ws_ml[at] : make_float2(-INFINITY, 0.f);
      x[c] = ws_acc[at * D + d];         // unused where the partial is empty
    }
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      if (ml[c].x == -INFINITY) continue;        // empty: an exact no-op
      const float m_new = fmaxf(m, ml[c].x);
      const float f_old = isfinite(m) ? expf(m - m_new) : 0.f;
      const float f_s = expf(ml[c].x - m_new);
      l = fmaf(l, f_old, ml[c].y * f_s);
      a = fmaf(a, f_old, x[c] * f_s);
      m = m_new;
    }
  }
  out[(((size_t)b * Q + j) * K * G + kh * G + g) * D + d] =
      __float2bfloat16(a / fmaxf(l, 1e-20f));
}

// Launch one instantiation with its dynamic shared memory (the opt-in above
// 48 KB is set once per instantiation and library).
template <int D, int kMaxRows, bool kInt8, bool kCap>
int launch_one(dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
               const void* k_pages, const void* v_pages,
               const __nv_bfloat16* k_scale, const __nv_bfloat16* v_scale,
               const int32_t* tables, const int32_t* pos, const int32_t* n_q,
               float2* ws_ml, float* ws_acc, int Q, int K, int G, int ps,
               int n_pages, int window, int qpb, int n_splits, float scale,
               float softcap) {
  constexpr int kSmem = Layout<D, kMaxRows, kInt8>::kBytes;
  static_assert(kSmem <= 232448, "shared memory above the H100's 227 KB");
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<D, kMaxRows, kInt8, kCap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  paged_split_kernel<D, kMaxRows, kInt8, kCap>
      <<<grid, kThreads, kSmem, st>>>(
      q, k_pages, v_pages, k_scale, v_scale, tables, pos, n_q, ws_ml, ws_acc,
      Q, K, G, ps, n_pages, window, qpb, n_splits, scale, softcap);
  return (int)cudaGetLastError();
}

// Splits of a table of n_pages pages: every group of kSplitPages absolute
// pages it can hold, plus one in a ring (its window can straddle one more).
int n_splits_of(int n_pages, int window) {
  return (n_pages + kSplitPages - 1) / kSplitPages + (window > 0 ? 1 : 0);
}

// Launch the split kernel for at most kMaxRows query rows a block (a
// (request, KV head)'s Q * G rows go to ceil(Q / qpb) row blocks of qpb =
// kMaxRows / G query tokens each), then the merge.  The workspace holds
// B * K * n_splits * Q * G partials of (m, l) and D fp32 accumulators.
// Returns 0 on success, else the cudaError_t of the refused or failed
// launch.
template <int kMaxRows>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* pos, const void* n_q, void* out, void* workspace,
           long long workspace_bytes, int B, int Q, int K, int G, int D,
           int ps, int n_pages, int window, float scale, float softcap,
           void* stream) {
  if (B < 1 || Q < 1 || K < 1 || G < 1 || G > kMaxRows || ps < 1 ||
      ps > kMaxPs || n_pages < 1 || window < 0 || !(softcap >= 0.f) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int qpb = kMaxRows / G;                  // query tokens a row block
  const int n_rb = (Q + qpb - 1) / qpb;
  const int n_splits = n_splits_of(n_pages, window);
  const long long n_part = (long long)B * K * n_splits * Q * G;
  if (workspace == nullptr || workspace_bytes < n_part * (D + 2) * 4 ||
      (long long)K * n_rb > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  auto* ws_ml = static_cast<float2*>(workspace);
  auto* ws_acc = reinterpret_cast<float*>(ws_ml + n_part);
  const dim3 grid(n_splits, K * n_rb, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* ksp = static_cast<const __nv_bfloat16*>(k_scale);
  const auto* vsp = static_cast<const __nv_bfloat16*>(v_scale);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* pp = static_cast<const int32_t*>(pos);
  const auto* np = static_cast<const int32_t*>(n_q);
  int rc = (int)cudaErrorInvalidValue;
#define PAGED_LAUNCH(DIM, INT8)                                              \
  rc = (softcap > 0.f ? launch_one<DIM, kMaxRows, INT8, true>               \
                      : launch_one<DIM, kMaxRows, INT8, false>)(            \
      grid, st, qp, k_pages, v_pages, ksp, vsp, tp, pp, np, ws_ml, ws_acc,   \
      Q, K, G, ps, n_pages, window, qpb, n_splits, scale, softcap)
  const bool int8 = k_scale != nullptr;
  if (D == 32 && !int8) PAGED_LAUNCH(32, false);
  else if (D == 32) PAGED_LAUNCH(32, true);
  else if (D == 64 && !int8) PAGED_LAUNCH(64, false);
  else if (D == 64) PAGED_LAUNCH(64, true);
  else if (D == 128 && !int8) PAGED_LAUNCH(128, false);
  else if (D == 128) PAGED_LAUNCH(128, true);
#undef PAGED_LAUNCH
  if (rc != 0) return rc;
  paged_merge_kernel<<<(unsigned)(B * K * Q * G), D, 0, st>>>(
      ws_ml, ws_acc, static_cast<__nv_bfloat16*>(out), Q, K, G, D, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace paged
