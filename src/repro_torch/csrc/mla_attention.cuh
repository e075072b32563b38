// Absorbed-latent MLA paged attention for Hopper (sm_90a): Q query tokens
// per request (Q = 1 for decode, Q = 1 + draft length for speculative
// verify), every head of a token attending the request's latent pages
// through the page table: scores q_eff . ckv + q_rope . krope (times the
// scale), an online softmax over the pages, and the context accumulated in
// latent space (acc += p * ckv), cast to bf16 once at the end.  The caller
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
// token slot to f32(q) * f32(s) when a page is staged, and that value feeds
// both the scores and the latent accumulator (kernel.py:315-320).
//
// What bounds it: all H heads share one latent "KV head", so one call reads
// every live token's latent once, (pos + n_q) * (L + R) * 2 bytes per
// request in bf16 (1152 bytes a token at deepseek-v2's L = 512, R = 64;
// int8: 576 + 4), and does 2 * H * (2 L + R) flops a token and query on
// it: about 240 flops a byte at H = 128 and one query, near the ~295 flops
// a byte at which the H100's bf16 tensor cores, not its memory, become the
// limit (989 TFLOP/s over 3.35 TB/s, NVIDIA's data sheet), and Q times
// that for the verify.  This first version runs the dot products on the
// fp32 CUDA cores, so its arithmetic bounds it (PERF.md has its time
// against its bound).
//
// Design.  The TPU grid (B, n_pages) carries a [Q * H, L] fp32 accumulator
// in VMEM from page to page: 256 KB per request and query at H = 128, more
// than the 227 KB of shared memory a Hopper block can hold.  So the rows
// are split over blocks: grid (B, H / 8, Q), one (request, query token)
// and 8 of its heads a block, one warp per head -- a query row -- and each
// block loops over the pages its token sees itself, staging every page
// (ckv ++ krope as fp32, one copy for the block's 8 rows) in shared
// memory.  Every block of a request stages the same pages, since every
// head reads the same latent.  A block whose token is dead (j >= n_q[b])
// writes zeros and reads nothing.  A warp owns its row's whole
// online-softmax state (m, l in every lane, the L / 32 context dims lane +
// 32 j in registers) and updates it page by page in ascending page order
// exactly as _online_softmax_update (kernel.py:53) does: -inf masking, the
// isfinite guards, the alpha rescale, l = l * alpha + sum(p), acc = acc *
// alpha + p @ ckv.  A page's 16 scores are 32 lanes' work: lane (t, half)
// sums one half of the 576 products of token t in ascending order, and the
// two halves add lower half first.  The page's p sum runs over t in order.
// Pages past the token's position are never read.  A block of token j is
// a decode block at position pos + j: the same pages in the same order and
// the same instruction sequence, whatever Q is -- so K7 at one live query
// reproduces K5 bit for bit, and verify row j equals the decode step at
// pos + j.
//
// Numerics: IEEE expf and division (build without --use_fast_math); fp32
// scores, scaled after the dot as in the reference; against the plain
// single-softmax version the online softmax rounds at other points, so
// outputs agree to an output ulp.  f32(q) * f32(s) of an int8 q and a bf16
// s is exact in fp32 (8 + 8 significant bits), so the staged int8 values
// equal the plain version's dequantized ones.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Internal linkage: K5 and K7 are separate libraries instantiating the same
// templates, and a template's static local (launch_t's opt-in flag) would
// otherwise be one object for the whole process (a GNU unique symbol), so
// the second library would skip its own shared-memory opt-in.
namespace mla {
namespace {

constexpr int kRows = 8;                 // heads per block, one warp each
constexpr int kThreads = kRows * 32;
constexpr int kMaxPs = 16;               // tokens per page

// Shared memory of one block.  A row of E = L + R values is stored in two
// halves of E / 2, the second shifted by 16 words, in rows of an odd
// length: the 32 lanes of a score step (16 tokens x 2 halves) then hit 32
// different banks.
template <int L, int R>
struct Smem {
  static constexpr int kE = L + R;
  static constexpr int kHalf = kE / 2;
  static constexpr int kLd = kE + 17;
  float kv[kMaxPs][kLd];        // the staged page: ckv ++ krope
  float q[kRows][kLd];          // the block's rows: q_eff ++ q_rope
  float p[kRows][kMaxPs];       // the page's probabilities, per row
  __device__ static __forceinline__ int at(int d) {
    return d < kHalf ? d : d + 16;
  }
};

// Eight bf16 values from a 16-byte vector into shared fp32 slots at(d0 + k)
// of ``row`` (d0 is a multiple of 8, so a vector never straddles the
// halves).
template <class S>
__device__ __forceinline__ void put8(float* row, int d0, uint4 raw) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float* dst = row + S::at(d0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    dst[2 * k] = f.x;
    dst[2 * k + 1] = f.y;
  }
}

// Sixteen int8 values from a 16-byte vector, each times ``s``, into shared
// fp32 slots at(d0 + k) of ``row`` (d0 is a multiple of 16 and the half
// E / 2 = 288 is one too, so a vector never straddles the halves).
template <class S>
__device__ __forceinline__ void put16q(float* row, int d0, uint4 raw,
                                       float s) {
  const auto* v = reinterpret_cast<const int8_t*>(&raw);
  float* dst = row + S::at(d0);
#pragma unroll
  for (int k = 0; k < 16; ++k) dst[k] = (float)v[k] * s;
}

template <int L, int R, bool kInt8>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const __nv_bfloat16* __restrict__ q_eff,  // [B, Q, H, L]
              const __nv_bfloat16* __restrict__ q_rope, // [B, Q, H, R]
              const void* __restrict__ ckv_v,           // [P, ps, L]
              const void* __restrict__ krope_v,         // [P, ps, R]
              const __nv_bfloat16* __restrict__ ckv_scale,    // [P, ps]
              const __nv_bfloat16* __restrict__ krope_scale,  // [P, ps]
              const int32_t* __restrict__ tables,       // [B, n_pages]
              const int32_t* __restrict__ pos,          // [B]
              const int32_t* __restrict__ n_q,          // [B] or null
              __nv_bfloat16* __restrict__ out,          // [B, Q, H, L]
              int Q, int H, int ps, int n_pages, float scale) {
  using S = Smem<L, R>;
  constexpr int kHalf = S::kHalf;
  constexpr int kDpl = L / 32;            // context dims owned by each lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int b = blockIdx.x, h0 = blockIdx.y * kRows, j = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = ((size_t)b * Q + j) * H + h0;   // the block's 8 rows

  if (n_q != nullptr && j >= n_q[b]) {            // a dead query token
    for (int e = threadIdx.x; e < kRows * L; e += kThreads)
      out[row0 * L + e] = __float2bfloat16(0.f);
    return;
  }

  constexpr int kLv = L / 8, kRv = R / 8;          // 16-byte bf16 vectors
  for (int e = threadIdx.x; e < kRows * (kLv + kRv); e += kThreads) {
    const int r = e / (kLv + kRv), c = e % (kLv + kRv);
    const uint4 raw = c < kLv
        ? reinterpret_cast<const uint4*>(q_eff + (row0 + r) * L)[c]
        : reinterpret_cast<const uint4*>(q_rope + (row0 + r) * R)[c - kLv];
    put8<S>(sm.q[r], 8 * c, raw);
  }
  const int p_b = pos[b] + j;                     // the token's position
  int n_live = p_b < 0 ? 0 : p_b / ps + 1;        // pages with i * ps <= p_b
  if (n_live > n_pages) n_live = n_pages;

  float m = -INFINITY, l = 0.f;                  // the warp's row state
  float acc[kDpl];
#pragma unroll
  for (int k = 0; k < kDpl; ++k) acc[k] = 0.f;
  const int t = lane % kMaxPs, half = lane / kMaxPs;

  for (int i = 0; i < n_live; ++i) {
    const int page = tables[(size_t)b * n_pages + i];
    __syncthreads();                             // readers of the last page
    if constexpr (kInt8) {
      constexpr int kLq = L / 16, kRq = R / 16;  // 16-byte int8 vectors
      const auto* ckv = static_cast<const int8_t*>(ckv_v);
      const auto* krope = static_cast<const int8_t*>(krope_v);
      for (int e = threadIdx.x; e < ps * (kLq + kRq); e += kThreads) {
        const int tt = e / (kLq + kRq), c = e % (kLq + kRq);
        const size_t slot = (size_t)page * ps + tt;
        if (c < kLq)
          put16q<S>(sm.kv[tt], 16 * c,
                    reinterpret_cast<const uint4*>(ckv + slot * L)[c],
                    __bfloat162float(ckv_scale[slot]));
        else
          put16q<S>(sm.kv[tt], L + 16 * (c - kLq),
                    reinterpret_cast<const uint4*>(krope + slot * R)[c - kLq],
                    __bfloat162float(krope_scale[slot]));
      }
    } else {
      const auto* ckv = static_cast<const __nv_bfloat16*>(ckv_v);
      const auto* krope = static_cast<const __nv_bfloat16*>(krope_v);
      for (int e = threadIdx.x; e < ps * (kLv + kRv); e += kThreads) {
        const int tt = e / (kLv + kRv), c = e % (kLv + kRv);
        const size_t slot = (size_t)page * ps + tt;
        const uint4 raw = c < kLv
            ? reinterpret_cast<const uint4*>(ckv + slot * L)[c]
            : reinterpret_cast<const uint4*>(krope + slot * R)[c - kLv];
        put8<S>(sm.kv[tt], 8 * c, raw);
      }
    }
    __syncthreads();

    // the row's score of token t: two half dots, lower half first
    float part = 0.f;
    if (t < ps) {
      const float* qr = &sm.q[warp][half * (kHalf + 16)];
      const float* kr = &sm.kv[t][half * (kHalf + 16)];
#pragma unroll 8
      for (int x = 0; x < kHalf; ++x) part = fmaf(qr[x], kr[x], part);
    }
    const float other = __shfl_xor_sync(0xffffffffu, part, kMaxPs);
    float s = (half == 0 ? part + other : other + part) * scale;
    if (!(t < ps && i * ps + t <= p_b)) s = -INFINITY;

    // online-softmax update, the same in every lane of the warp
    float mx = s;
#pragma unroll
    for (int o = kMaxPs / 2; o >= 1; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const bool fin = isfinite(m_new);
    const float safe = fin ? m_new : 0.f;
    if (half == 0 && t < ps) sm.p[warp][t] = fin ? expf(s - safe) : 0.f;
    __syncwarp();
    float sum = 0.f;
    for (int x = 0; x < ps; ++x) sum += sm.p[warp][x];
    const float alpha = isfinite(m) ? expf(m - safe) : 0.f;
    l = fmaf(l, alpha, sum);
    m = m_new;
#pragma unroll
    for (int k = 0; k < kDpl; ++k) {
      const int d = S::at(lane + 32 * k);
      float pv = 0.f;
      for (int x = 0; x < ps; ++x) pv = fmaf(sm.p[warp][x], sm.kv[x][d], pv);
      acc[k] = fmaf(acc[k], alpha, pv);
    }
  }

  __nv_bfloat16* o = out + (row0 + warp) * L;
  const float denom = fmaxf(l, 1e-20f);
#pragma unroll
  for (int k = 0; k < kDpl; ++k)
    o[lane + 32 * k] = __float2bfloat16(acc[k] / denom);
}

template <int L, int R, bool kInt8>
int launch_t(dim3 grid, cudaStream_t st, const __nv_bfloat16* q_eff,
             const __nv_bfloat16* q_rope, const void* ckv, const void* krope,
             const __nv_bfloat16* ckv_scale,
             const __nv_bfloat16* krope_scale, const int32_t* tables,
             const int32_t* pos, const int32_t* n_q, __nv_bfloat16* out,
             int Q, int H, int ps, int n_pages, float scale) {
  constexpr size_t kSmem = sizeof(Smem<L, R>);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        attend_kernel<L, R, kInt8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  attend_kernel<L, R, kInt8><<<grid, kThreads, kSmem, st>>>(
      q_eff, q_rope, ckv, krope, ckv_scale, krope_scale, tables, pos, n_q,
      out, Q, H, ps, n_pages, scale);
  return (int)cudaGetLastError();
}

// q_eff/out [B, Q, H, L] and q_rope [B, Q, H, R] bf16; ckv [P, ps, L] and
// krope [P, ps, R] latent pages, bf16 (both scales null) or int8 (ckv_scale
// and krope_scale [P, ps] bf16); tables [B, n_pages], pos [B] and n_q [B]
// int32 (n_q null: every token live).  L = 512, R = 64 (deepseek-v2), H a
// multiple of 8, ps <= 16.  Returns 0 on success, else the cudaError_t of
// the refused or failed launch.
inline int launch(const void* q_eff, const void* q_rope, const void* ckv,
                  const void* krope, const void* ckv_scale,
                  const void* krope_scale, const void* tables,
                  const void* pos, const void* n_q, void* out, int B, int Q,
                  int H, int L, int R, int ps, int n_pages, float scale,
                  void* stream) {
  if (B < 1 || Q < 1 || H < kRows || H % kRows != 0 || ps < 1 ||
      ps > kMaxPs || n_pages < 1 || L != 512 || R != 64 ||
      (ckv_scale == nullptr) != (krope_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, H / kRows, Q);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qe = static_cast<const __nv_bfloat16*>(q_eff);
  const auto* qr = static_cast<const __nv_bfloat16*>(q_rope);
  const auto* cs = static_cast<const __nv_bfloat16*>(ckv_scale);
  const auto* rs = static_cast<const __nv_bfloat16*>(krope_scale);
  const auto* tb = static_cast<const int32_t*>(tables);
  const auto* ps_ = static_cast<const int32_t*>(pos);
  const auto* nq = static_cast<const int32_t*>(n_q);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (cs != nullptr)
    return launch_t<512, 64, true>(grid, st, qe, qr, ckv, krope, cs, rs, tb,
                                   ps_, nq, o, Q, H, ps, n_pages, scale);
  return launch_t<512, 64, false>(grid, st, qe, qr, ckv, krope, cs, rs, tb,
                                  ps_, nq, o, Q, H, ps, n_pages, scale);
}

}  // namespace
}  // namespace mla
