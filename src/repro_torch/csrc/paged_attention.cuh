// Paged attention for Hopper (sm_90a): Q query tokens per request (Q = 1 for
// decode, Q = 1 + draft length for speculative verify), GQA, read straight
// out of the paged KV pool through the page table, bf16 pages or int8 pages
// with bf16 per-token-per-head scales.  One body, two entry points:
// paged_decode.cu (kernel K1, Q = 1) and paged_verify.cu (kernel K3).
//
// Replaces the Pallas TPU kernels repro/kernels/paged_attention/kernel.py::
// paged_decode_fwd (_paged_decode_kernel) and paged_verify_fwd
// (_paged_verify_kernel), window = 0 and no softcap, bf16 or int8 pages.
// Contract: repro/kernels/README.md "Inputs (decode cores)", "Page-table
// layout" and "Scale-operand layout" -- page 0 is the null page, which may
// be read but is always masked; query j of row b sits at absolute position
// pos[b] + j and sees token t iff t <= pos[b] + j and j < n_q[b]; rows with
// j >= n_q[b] finish as exact zeros.
//
// What bounds it: the bytes of K/V pages read.  One call reads every live
// token's K and V of every KV head once, (pos + n_q) * K * D * 2 * 2 bytes
// per request in bf16 (int8: 1 byte per value plus a 2-byte scale per token
// and head), and does 4 * n_q * (pos + n_q) * H * D flops on them -- a few
// flops per byte, far below the ~295 flops/byte at which the H100's bf16
// tensor cores, not its memory, become the limit (989 TFLOP/s over
// 3.35 TB/s, NVIDIA's data sheet).
//
// Design.  The TPU grid (B, K, n_pages) carries (m, l, acc) in VMEM from one
// grid step to the next; Hopper blocks run in no order, so one block owns a
// (request, KV head) pair and loops over the request's live pages itself,
// reading tables[b, i], pos[b] and n_q[b] on its own.  The block's rows are
// the Q * G (query token, query head) pairs of the GQA group -- 35 at Q = 5,
// G = 7 -- and all of them share every K/V page read.  The four warps split
// the pages round-robin, each with its own fp32 online-softmax state per
// row, updated exactly as _online_softmax_update (kernel.py:53): -inf
// masking, the isfinite guards, the alpha rescale.  The four states merge
// at the end in warp order, and the output is cast to bf16 once, after
// acc / max(l, 1e-20) (kernel.py:70).  Pages past pos + n_q - 1 are never
// read.  int8 pages are dequantized element by element to f32(q) * f32(s)
// right before the dot and before PV, as the Pallas bodies and the plain
// gather do (kernel.py:118-122).
//
// Every row runs the same instruction sequence whatever Q, G and the row
// count are (explicit fmaf, no fast math), so K3 with one live query per
// row reproduces K1 bit for bit, as the Pallas twin does.  At B = 8 and
// K = 2 that is 16 blocks on 132 SMs: the page sweep is not split across
// blocks yet, so the kernel is latency-bound at long contexts (PERF.md).
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
                    int Q, int K, int G, int ps, int n_pages, float scale) {
  constexpr int kDpl = D / 32;          // output dims owned by each lane
  __shared__ float q_s[kMaxRows][D];    // queries; after the sweep, the
                                        // merged accumulator
  __shared__ PageTile<D, kInt8> k_t[kWarps];
  __shared__ PageTile<D, kInt8> v_t[kWarps];
  __shared__ float p_s[kWarps][kMaxRows][kMaxPs];
  __shared__ float alpha_s[kWarps][kMaxRows];
  __shared__ float m_w[kWarps][kMaxRows];
  __shared__ float l_w[kWarps][kMaxRows];

  const int b = blockIdx.x, kh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = K * G, rows = Q * G;

  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const int j = r / G, g = r % G;
    q_s[r][d] = __bfloat162float(
        q[(((size_t)b * Q + j) * H + kh * G + g) * D + d]);
  }
  for (int r = lane; r < rows; r += 32) {
    m_w[warp][r] = -INFINITY;
    l_w[warp][r] = 0.f;
  }
  const int p_b = pos[b];
  const int nq_b = n_q ? n_q[b] : 1;
  const int last = p_b + nq_b - 1;               // last live query position
  int n_live = last < 0 ? 0 : last / ps + 1;     // pages with i * ps <= last
  if (n_live > n_pages) n_live = n_pages;
  __syncthreads();

  float acc[kMaxRows][kDpl];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
    for (int j = 0; j < kDpl; ++j) acc[r][j] = 0.f;

  for (int i = warp; i < n_live; i += kWarps) {
    const int page = tables[(size_t)b * n_pages + i];
    const size_t base = ((size_t)page * ps * K + kh) * D;
    k_t[warp].load(k_pages, k_scale, base, ps, K, kh, page, lane);
    v_t[warp].load(v_pages, v_scale, base, ps, K, kh, page, lane);
    __syncwarp();
    for (int e = lane; e < rows * ps; e += 32) {
      const int r = e / ps, t = e % ps;
      const int j = r / G;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d)
        s = fmaf(q_s[r][d], k_t[warp].value(t, d), s);
      s *= scale;
      const bool valid = j < nq_b && i * ps + t <= p_b + j;
      p_s[warp][r][t] = valid ? s : -INFINITY;
    }
    __syncwarp();
    for (int r = lane; r < rows; r += 32) {      // online-softmax update
      float mx = -INFINITY;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, p_s[warp][r][t]);
      const float m_old = m_w[warp][r];
      const float m_new = fmaxf(m_old, mx);
      const bool fin = isfinite(m_new);
      const float safe = fin ? m_new : 0.f;
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = fin ? expf(p_s[warp][r][t] - safe) : 0.f;
        p_s[warp][r][t] = p;
        sum += p;
      }
      const float alpha = isfinite(m_old) ? expf(m_old - safe) : 0.f;
      l_w[warp][r] = fmaf(l_w[warp][r], alpha, sum);
      alpha_s[warp][r] = alpha;
      m_w[warp][r] = m_new;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < rows) {
        const float a = alpha_s[warp][r];
#pragma unroll
        for (int j = 0; j < kDpl; ++j) {
          const int d = lane + 32 * j;
          float pv = 0.f;
          for (int t = 0; t < ps; ++t)
            pv = fmaf(p_s[warp][r][t], v_t[warp].value(t, d), pv);
          acc[r][j] = fmaf(acc[r][j], a, pv);
        }
      }
    }
    __syncwarp();
  }

  // merge the warps' (m, l, acc) states in warp order; one bf16 cast at the
  // end.  alpha_s now holds each warp's factor exp(m_w - m), l_w[0] the
  // merged normalizer, q_s the merged accumulator.
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_w[w][r]);
    const float safe = isfinite(m) ? m : 0.f;
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = isfinite(m_w[w][r]) ? expf(m_w[w][r] - safe) : 0.f;
      l = fmaf(l_w[w][r], f, l);
      alpha_s[w][r] = f;
    }
    l_w[0][r] = l;
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
          const float f = alpha_s[w][r];
#pragma unroll
          for (int j = 0; j < kDpl; ++j) {
            const int d = lane + 32 * j;
            q_s[r][d] = fmaf(acc[r][j], f, w == 0 ? 0.f : q_s[r][d]);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const int j = r / G, g = r % G;
    out[(((size_t)b * Q + j) * H + kh * G + g) * D + d] =
        __float2bfloat16(q_s[r][d] / fmaxf(l_w[0][r], 1e-20f));
  }
}

// Launch the kernel for kMaxRows query rows per block.  Returns 0 on
// success, else the cudaError_t of the refused or failed launch.
template <int kMaxRows>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* pos, const void* n_q, void* out, int B, int Q, int K,
           int G, int D, int ps, int n_pages, float scale, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || G < 1 || Q * G > kMaxRows || ps < 1 ||
      ps > kMaxPs || n_pages < 1 || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, K);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* ksp = static_cast<const __nv_bfloat16*>(k_scale);
  const auto* vsp = static_cast<const __nv_bfloat16*>(v_scale);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* pp = static_cast<const int32_t*>(pos);
  const auto* np = static_cast<const int32_t*>(n_q);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define PAGED_LAUNCH(DIM, INT8)                                              \
  paged_attend_kernel<DIM, kMaxRows, INT8><<<grid, block, 0, st>>>(          \
      qp, k_pages, v_pages, ksp, vsp, tp, pp, np, op, Q, K, G, ps, n_pages, \
      scale)
  const bool int8 = k_scale != nullptr;
  if (D == 32 && !int8) PAGED_LAUNCH(32, false);
  else if (D == 32) PAGED_LAUNCH(32, true);
  else if (D == 64 && !int8) PAGED_LAUNCH(64, false);
  else if (D == 64) PAGED_LAUNCH(64, true);
  else return (int)cudaErrorInvalidValue;
#undef PAGED_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace paged
