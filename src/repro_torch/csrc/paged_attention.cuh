// Paged attention for Hopper (sm_90a): Q query tokens per request (Q = 1 for
// decode, Q = 1 + draft length for speculative verify), GQA, read straight
// out of the paged KV pool through the page table, bf16 pages or int8 pages
// with bf16 per-token-per-head scales, full causal attention or a
// sliding-window page ring.  One body, two entry points: paged_decode.cu
// (kernel K1, Q = 1) and paged_verify.cu (kernel K3).
//
// Replaces the Pallas TPU kernels repro/kernels/paged_attention/kernel.py::
// paged_decode_fwd (_paged_decode_kernel) and paged_verify_fwd
// (_paged_verify_kernel), window = 0 or > 0 and no softcap, bf16 or int8
// pages.  Contract: repro/kernels/README.md "Inputs (decode cores)",
// "Page-table layout" and "Scale-operand layout" -- page 0 is the null
// page, which may be read but is always masked; query j of row b sits at
// absolute position qp = pos[b] + j and, with window = 0, sees token t iff
// t <= qp and j < n_q[b]; rows with j >= n_q[b] finish as exact zeros.
// With window > 0 the table is a ring of ring = n_pages * ps token slots:
// slot qp % ring holds qp, so slot i holds k_abs = qp - ((qp % ring - i)
// mod ring), and i is seen iff 0 <= k_abs <= qp and k_abs > qp - window
// (_page_mask, kernel.py:81-91).
//
// What bounds it: the bytes of K/V pages read.  One call reads every live
// token's K and V of every KV head once, min(pos + n_q, ring) * K * D * 2 *
// 2 bytes per request in bf16 (int8: 1 byte per value plus a 2-byte scale
// per token and head), and does 4 * n_q * keys * H * D flops on them -- a
// few flops per byte, far below the ~295 flops/byte at which the H100's
// bf16 tensor cores, not its memory, become the limit (989 TFLOP/s over
// 3.35 TB/s, NVIDIA's data sheet).
//
// Design.  The TPU grid (B, K, n_pages) carries (m, l, acc) in VMEM from one
// grid step to the next; Hopper blocks run in no order, so one block owns a
// (request, KV head) pair and loops over the request's live pages itself,
// reading tables[b, i], pos[b] and n_q[b] on its own.  The block's rows are
// the Q * G (query token, query head) pairs of the GQA group -- 45 at Q = 5,
// G = 9 -- and all of them share every K/V page read.  The four warps split
// the pages round-robin by absolute page number (warp w takes the absolute
// pages a == w mod 4, oldest first; in a ring page a sits at slot a mod
// n_pages), each with its own fp32 online-softmax state per row, updated
// exactly as _online_softmax_update (kernel.py:53): -inf masking, the
// isfinite guards, the alpha rescale.  The four states merge
// at the end in warp order, and the output is cast to bf16 once, after
// acc / max(l, 1e-20) (kernel.py:70).  Pages past the last live query are
// never read: page i holds no visible slot when i * ps > pos + n_q - 1,
// in a ring too (before the ring wraps such slots hold no position yet;
// once pos + n_q - 1 >= ring every page is swept, as the TPU kernel sweeps
// every resident page, kernel.py:110-111).  Anchoring the sweep to
// absolute pages makes a ring's sums independent of the ring's length: a
// ring of n_pages + 1 (the speculative pool's slack page) holding the same
// window adds only its oldest page, which no row sees, and a page no row
// sees is an exact no-op on a warp's state (p = 0, alpha = 1).  So the
// windowed speculative stream equals the plain stream bit for bit.  int8
// pages are dequantized element by element to f32(q) * f32(s) right before
// the dot and before PV, as the Pallas bodies and the plain gather do
// (kernel.py:118-122).
//
// Shared memory (queries, four warps' K and V pages, scores, softmax
// states) is dynamic: at D = 128 and 48 rows it passes the 48 KB a block
// gets without opting in.  Each lane owns D / 32 output dimensions of
// every row; that accumulator lives in registers while rows * D / 32 <= 96
// and in shared memory (one slice per warp) above that (48 rows at D =
// 128 would be 192 registers a lane).  Where a value is stored does not
// change its arithmetic.
//
// A (request, KV head)'s rows may outnumber a block's kMaxRows (Q = 5 at G =
// 12, command-r-plus-104b, is 60 rows against K3's 48): they are split by
// query token over blocks (grid z), qpb = kMaxRows / G whole tokens a block,
// each block sweeping the pages up to its own last live query.  A page
// that holds no slot visible to a row is an exact no-op on that row's
// state (p = 0, alpha = 1), so the split changes no row's result, and a
// block whose tokens are all dead writes exact zeros.
//
// Every row runs the same instruction sequence whatever Q, G, the row count,
// the block's share of the rows and the accumulator's home are (explicit
// fmaf, no fast math), so K3 with one live query per row reproduces K1 bit
// for bit, as the Pallas twin does, ring mode included.  At B = 4 and K = 4
// that is 16 blocks on 132 SMs (32 where the rows are split): the page
// sweep is not split across blocks yet, so the kernel is latency-bound at
// long contexts (PERF.md).
//
// Numerics: IEEE expf and division (build without --use_fast_math); scores
// are fp32 dot products, scaled after the dot as in the reference.
// Against the plain single-softmax version the online softmax rounds at
// other points, so outputs agree to an output ulp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged {

constexpr int kWarps = 4;
constexpr int kMaxPs = 16;   // tokens per page

// One warp's copy of one K or V page: bf16 values, or int8 values and one
// fp32 scale per token.  value(t, d) is the fp32 operand the math uses.
template <int D, bool kInt8>
struct PageTile;

template <int D>
struct PageTile<D, false> {
  __align__(16) __nv_bfloat16 x[kMaxPs][D + 8];   // padded, 16B-aligned rows

  __device__ __forceinline__ void load(const void* pages,
                                       const __nv_bfloat16* /*scales*/,
                                       size_t base, int ps, int K, int kh,
                                       int page, int lane) {
    constexpr int kVec = D / 8;                   // 16-byte vectors per row
    const auto* src = static_cast<const __nv_bfloat16*>(pages);
    for (int e = lane; e < ps * kVec; e += 32) {
      const int t = e / kVec, c = e % kVec;
      reinterpret_cast<uint4*>(&x[t][0])[c] =
          reinterpret_cast<const uint4*>(src + base + (size_t)t * K * D)[c];
    }
  }
  __device__ __forceinline__ float value(int t, int d) const {
    return __bfloat162float(x[t][d]);
  }
};

template <int D>
struct PageTile<D, true> {
  __align__(16) int8_t x[kMaxPs][D + 16];
  float s[kMaxPs];

  __device__ __forceinline__ void load(const void* pages,
                                       const __nv_bfloat16* scales,
                                       size_t base, int ps, int K, int kh,
                                       int page, int lane) {
    constexpr int kVec = D / 16;
    const auto* src = static_cast<const int8_t*>(pages);
    for (int e = lane; e < ps * kVec; e += 32) {
      const int t = e / kVec, c = e % kVec;
      reinterpret_cast<uint4*>(&x[t][0])[c] =
          reinterpret_cast<const uint4*>(src + base + (size_t)t * K * D)[c];
    }
    if (lane < ps)
      s[lane] = __bfloat162float(scales[((size_t)page * ps + lane) * K + kh]);
  }
  __device__ __forceinline__ float value(int t, int d) const {
    return __fmul_rn((float)x[t][d], s[t]);       // f32(q) * f32(s)
  }
};

// Whether query position qp sees slot idx of the row's logical view: the
// causal rule (window = 0) or the ring rule over ``ring`` slots.
__device__ __forceinline__ bool visible(int idx, int qp, int window,
                                        int ring) {
  if (window == 0) return idx <= qp;
  int back = (qp % ring - idx) % ring;           // Python's non-negative mod
  if (back < 0) back += ring;
  const int k_abs = qp - back;
  return k_abs >= 0 && k_abs > qp - window;      // k_abs <= qp by build
}

// Row accumulators: each lane owns dims lane + 32 * j (j < D / 32) of every
// row, in registers or in the warp's slice of shared memory.
template <int D, int kMaxRows, bool kInSmem>
struct Acc;

template <int D, int kMaxRows>
struct Acc<D, kMaxRows, false> {
  float v[kMaxRows][D / 32];
  __device__ __forceinline__ void init(float* /*slice*/, int /*lane*/) {
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
      for (int j = 0; j < D / 32; ++j) v[r][j] = 0.f;
  }
  __device__ __forceinline__ float& at(int r, int j) { return v[r][j]; }
};

template <int D, int kMaxRows>
struct Acc<D, kMaxRows, true> {
  float* base;
  __device__ __forceinline__ void init(float* slice, int lane) {
    base = slice + lane;
    for (int r = 0; r < kMaxRows; ++r)
      for (int j = 0; j < D / 32; ++j) base[r * D + 32 * j] = 0.f;
  }
  __device__ __forceinline__ float& at(int r, int j) {
    return base[r * D + 32 * j];
  }
};

template <int D, int kMaxRows>
__host__ __device__ constexpr bool acc_in_smem() {
  return kMaxRows * (D / 32) > 96;
}

// The block's dynamic shared memory.
template <int D, int kMaxRows, bool kInt8>
struct Smem {
  static constexpr int kAccWarps = acc_in_smem<D, kMaxRows>() ? kWarps : 0;
  float q[kMaxRows][D];     // queries; after the sweep, the merged accumulator
  PageTile<D, kInt8> k_t[kWarps];
  PageTile<D, kInt8> v_t[kWarps];
  float p[kWarps][kMaxRows][kMaxPs];
  float alpha[kWarps][kMaxRows];
  float m[kWarps][kMaxRows];
  float l[kWarps][kMaxRows];
  float acc[kAccWarps > 0 ? kAccWarps : 1][kAccWarps > 0 ? kMaxRows : 1][D];
};

template <int D, int kMaxRows, bool kInt8>
__global__ void __launch_bounds__(kWarps * 32)
paged_attend_kernel(const __nv_bfloat16* __restrict__ q,    // [B, Q, H, D]
                    const void* __restrict__ k_pages,       // [P, ps, K, D]
                    const void* __restrict__ v_pages,       // [P, ps, K, D]
                    const __nv_bfloat16* __restrict__ k_scale,  // [P, ps, K]
                    const __nv_bfloat16* __restrict__ v_scale,  // [P, ps, K]
                    const int32_t* __restrict__ tables,     // [B, n_pages]
                    const int32_t* __restrict__ pos,        // [B]
                    const int32_t* __restrict__ n_q,        // [B] or null
                    __nv_bfloat16* __restrict__ out,        // [B, Q, H, D]
                    int Q, int K, int G, int ps, int n_pages, int window,
                    int qpb, float scale) {
  constexpr int kDpl = D / 32;          // output dims owned by each lane
  constexpr bool kAccSmem = acc_in_smem<D, kMaxRows>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<D, kMaxRows, kInt8>*>(smem_raw);

  const int b = blockIdx.x, kh = blockIdx.y;
  const int j0 = blockIdx.z * qpb;             // the block's first query token
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = K * G, rows = min(qpb, Q - j0) * G;
  const int ring = n_pages * ps;

  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const int j = j0 + r / G, g = r % G;
    sm.q[r][d] = __bfloat162float(
        q[(((size_t)b * Q + j) * H + kh * G + g) * D + d]);
  }
  for (int r = lane; r < rows; r += 32) {
    sm.m[warp][r] = -INFINITY;
    sm.l[warp][r] = 0.f;
  }
  const int p_b = pos[b];
  const int nq_b = n_q ? n_q[b] : 1;
  // the block's last live query token, and its position
  const int j_last = min(j0 + rows / G, nq_b) - 1;
  const int last = p_b + j_last;
  // The absolute pages to sweep, oldest first: a_lo..a_hi, page a at table
  // slot a % n_pages.  Causal: slots 0..last / ps (a == slot).  Ring: the
  // n_pages newest absolute pages up to last's, one sweep of the whole ring
  // once it has wrapped.  Warp w takes the pages a == w (mod kWarps), so the
  // page -> warp assignment and every warp's sum order follow absolute
  // positions, not ring slots: two rings of different length holding the
  // same window sum the same keys in the same order.
  int a_hi = (j_last < j0 || last < 0) ? -1 : last / ps;
  if (window == 0 && a_hi > n_pages - 1) a_hi = n_pages - 1;
  const int a_lo = max(0, a_hi - n_pages + 1);
  __syncthreads();

  Acc<D, kMaxRows, kAccSmem> acc;
  acc.init(&sm.acc[kAccSmem ? warp : 0][0][0], lane);

  const int a0 = a_lo + ((warp - a_lo) % kWarps + kWarps) % kWarps;
  int i = a0 % n_pages;                          // the page's table slot
  for (int a = a0; a <= a_hi; a += kWarps) {
    if (a > a0) {                                // i = a % n_pages
      i += kWarps;
      while (i >= n_pages) i -= n_pages;
    }
    const int page = tables[(size_t)b * n_pages + i];
    const size_t base = ((size_t)page * ps * K + kh) * D;
    sm.k_t[warp].load(k_pages, k_scale, base, ps, K, kh, page, lane);
    sm.v_t[warp].load(v_pages, v_scale, base, ps, K, kh, page, lane);
    __syncwarp();
    for (int e = lane; e < rows * ps; e += 32) {
      const int r = e / ps, t = e % ps;
      const int j = j0 + r / G;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d)
        s = fmaf(sm.q[r][d], sm.k_t[warp].value(t, d), s);
      s *= scale;
      const bool valid = j < nq_b && visible(i * ps + t, p_b + j, window,
                                             ring);
      sm.p[warp][r][t] = valid ? s : -INFINITY;
    }
    __syncwarp();
    for (int r = lane; r < rows; r += 32) {      // online-softmax update
      float mx = -INFINITY;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sm.p[warp][r][t]);
      const float m_old = sm.m[warp][r];
      const float m_new = fmaxf(m_old, mx);
      const bool fin = isfinite(m_new);
      const float safe = fin ? m_new : 0.f;
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = fin ? expf(sm.p[warp][r][t] - safe) : 0.f;
        sm.p[warp][r][t] = p;
        sum += p;
      }
      const float alpha = isfinite(m_old) ? expf(m_old - safe) : 0.f;
      sm.l[warp][r] = fmaf(sm.l[warp][r], alpha, sum);
      sm.alpha[warp][r] = alpha;
      sm.m[warp][r] = m_new;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < rows) {
        const float a = sm.alpha[warp][r];
#pragma unroll
        for (int j = 0; j < kDpl; ++j) {
          const int d = lane + 32 * j;
          float pv = 0.f;
          for (int t = 0; t < ps; ++t)
            pv = fmaf(sm.p[warp][r][t], sm.v_t[warp].value(t, d), pv);
          acc.at(r, j) = fmaf(acc.at(r, j), a, pv);
        }
      }
    }
    __syncwarp();
  }

  // merge the warps' (m, l, acc) states in warp order; one bf16 cast at the
  // end.  alpha now holds each warp's factor exp(m_w - m), l[0] the merged
  // normalizer, q the merged accumulator.
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sm.m[w][r]);
    const float safe = isfinite(m) ? m : 0.f;
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = isfinite(sm.m[w][r]) ? expf(sm.m[w][r] - safe) : 0.f;
      l = fmaf(sm.l[w][r], f, l);
      sm.alpha[w][r] = f;
    }
    sm.l[0][r] = l;
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
          const float f = sm.alpha[w][r];
#pragma unroll
          for (int j = 0; j < kDpl; ++j) {
            const int d = lane + 32 * j;
            sm.q[r][d] = fmaf(acc.at(r, j), f, w == 0 ? 0.f : sm.q[r][d]);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const int j = j0 + r / G, g = r % G;
    out[(((size_t)b * Q + j) * H + kh * G + g) * D + d] =
        __float2bfloat16(sm.q[r][d] / fmaxf(sm.l[0][r], 1e-20f));
  }
}

// Launch one instantiation with its dynamic shared memory (the opt-in above
// 48 KB is set once per instantiation).
template <int D, int kMaxRows, bool kInt8>
int launch_one(dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
               const void* k_pages, const void* v_pages,
               const __nv_bfloat16* k_scale, const __nv_bfloat16* v_scale,
               const int32_t* tables, const int32_t* pos, const int32_t* n_q,
               __nv_bfloat16* out, int Q, int K, int G, int ps, int n_pages,
               int window, int qpb, float scale) {
  constexpr size_t kSmem = sizeof(Smem<D, kMaxRows, kInt8>);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attend_kernel<D, kMaxRows, kInt8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  paged_attend_kernel<D, kMaxRows, kInt8><<<grid, kWarps * 32, kSmem, st>>>(
      q, k_pages, v_pages, k_scale, v_scale, tables, pos, n_q, out, Q, K, G,
      ps, n_pages, window, qpb, scale);
  return (int)cudaGetLastError();
}

// Launch the kernel for at most kMaxRows query rows per block: a (request,
// KV head)'s Q * G rows go to ceil(Q / qpb) blocks of qpb = kMaxRows / G
// query tokens each (grid z).  Returns 0 on success, else the cudaError_t
// of the refused or failed launch.
template <int kMaxRows>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* pos, const void* n_q, void* out, int B, int Q, int K,
           int G, int D, int ps, int n_pages, int window, float scale,
           void* stream) {
  if (B < 1 || Q < 1 || K < 1 || G < 1 || G > kMaxRows || ps < 1 ||
      ps > kMaxPs || n_pages < 1 || window < 0 ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int qpb = kMaxRows / G;                  // query tokens per block
  const dim3 grid(B, K, (Q + qpb - 1) / qpb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* ksp = static_cast<const __nv_bfloat16*>(k_scale);
  const auto* vsp = static_cast<const __nv_bfloat16*>(v_scale);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* pp = static_cast<const int32_t*>(pos);
  const auto* np = static_cast<const int32_t*>(n_q);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define PAGED_LAUNCH(DIM, INT8)                                               \
  return launch_one<DIM, kMaxRows, INT8>(grid, st, qp, k_pages, v_pages, ksp, \
                                         vsp, tp, pp, np, op, Q, K, G, ps,    \
                                         n_pages, window, qpb, scale)
  const bool int8 = k_scale != nullptr;
  if (D == 32 && !int8) PAGED_LAUNCH(32, false);
  if (D == 32) PAGED_LAUNCH(32, true);
  if (D == 64 && !int8) PAGED_LAUNCH(64, false);
  if (D == 64) PAGED_LAUNCH(64, true);
  if (D == 128 && !int8) PAGED_LAUNCH(128, false);
  if (D == 128) PAGED_LAUNCH(128, true);
#undef PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace paged
